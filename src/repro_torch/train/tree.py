"""Parameter trees as nested dicts and lists of tensors, flattened in the
order of ``jax.tree.flatten``: dict keys sorted at every level, list
items in index order (the recsys models keep their blocks and MLP layers
in lists).  The order is the
checkpoint layout's (``leaf_<i>.npy`` is the i-th leaf), so a tree written
by either package restores in the other.  ``torch.utils._pytree`` keeps a
dict's insertion order and is not used: the optimizer state's ``m`` and
``v`` have the same shapes, so a wrong order would swap them silently."""

from __future__ import annotations


def _children(node):
    """(key or index, child) pairs of an inner node in flattening order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(key, node[key]) for key in sorted(node)]
    if isinstance(node, list):
        return list(enumerate(node))
    return None


def _walk(node, path, leaves, paths):
    children = _children(node)
    if children is None:
        leaves.append(node)
        paths.append(path)
        return
    for key, child in children:
        _walk(child, (*path, key), leaves, paths)


def flatten(tree) -> tuple[list, list]:
    """(leaves, paths) of ``tree``: every value that is neither a dict nor a
    list, keys sorted at every level, list items in order; a path is the
    tuple of keys and indices down to its leaf.  (The recursion is a module
    function, not a closure: a recursive closure is a reference cycle that
    would keep the leaves alive until the cyclic garbage collector runs.)"""
    leaves, paths = [], []
    _walk(tree, (), leaves, paths)
    return leaves, paths


def _build(node, it):
    if isinstance(node, list):
        return [_build(child, it) for child in node]
    if not isinstance(node, dict):
        return next(it)
    built = {key: _build(node[key], it) for key in sorted(node)}
    return {key: built[key] for key in node}


def unflatten(like, leaves) -> dict:
    """A tree shaped as ``like`` (its keys in ``like``'s order) whose leaves
    are ``leaves`` in ``flatten``'s order."""
    it = iter(leaves)
    try:
        out = _build(like, it)
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
    for the checkpoint manifest: ``PyTreeDef({'a': *, 'b': [{'c': *}, *]})``."""

    def fmt(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{key!r}: {fmt(node[key])}" for key in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(fmt(child) for child in node) + "]"
        return "*"

    return f"PyTreeDef({fmt(tree)})"
