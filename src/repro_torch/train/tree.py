"""Parameter trees as nested dicts of tensors, flattened in the order of
``jax.tree.flatten``: keys sorted at every level.  The order is the
checkpoint layout's (``leaf_<i>.npy`` is the i-th leaf), so a tree written
by either package restores in the other.  ``torch.utils._pytree`` keeps a
dict's insertion order and is not used: the optimizer state's ``m`` and
``v`` have the same shapes, so a wrong order would swap them silently."""

from __future__ import annotations


def flatten(tree) -> tuple[list, list]:
    """(leaves, paths) of ``tree``: every non-dict value, keys sorted at
    every level; a path is the tuple of keys down to its leaf."""
    leaves, paths = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], (*path, key))
        else:
            leaves.append(node)
            paths.append(path)

    walk(tree, ())
    return leaves, paths


def unflatten(like, leaves) -> dict:
    """A tree shaped as ``like`` (its keys in ``like``'s order) whose leaves
    are ``leaves`` in ``flatten``'s order."""
    it = iter(leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        built = {key: build(node[key]) for key in sorted(node)}
        return {key: built[key] for key in node}

    try:
        out = build(like)
    except StopIteration:
        raise ValueError("unflatten: fewer leaves than the tree has") from None
    if next(it, it) is not it:
        raise ValueError("unflatten: more leaves than the tree has")
    return out


def map_leaves(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``,
    trees of the same structure)."""
    leaves, _ = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])


def treedef_str(tree) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` prints it,
    for the checkpoint manifest: ``PyTreeDef({'a': *, 'b': {'c': *}})``."""

    def fmt(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{key!r}: {fmt(node[key])}" for key in sorted(node)) + "}"
        return "*"

    return f"PyTreeDef({fmt(tree)})"
