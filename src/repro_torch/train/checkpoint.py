"""Step-atomic checkpointing with crash safety (counterpart of
``repro.train.checkpoint``), in the reference's on-disk layout.

Layout: ``<root>/step_<N:010d>/`` holds one ``leaf_<i:05d>.npy`` per leaf
in ``tree.flatten``'s order (``jax.tree.flatten``'s: keys sorted at every
level) and ``manifest.json`` (``step``, ``n_leaves`` and ``treedef`` as
``jax`` prints it).  Writes go to a ``.tmp-`` staging directory; ``COMMITTED``
is written last inside it and the directory is renamed into place, so a
checkpoint exists completely or not at all, and restore ignores a
directory without ``COMMITTED``.  A checkpoint written by either package
restores in the other.

bf16 leaves are stored as the reference stores them: two-byte void
records (``|V2``, the bf16 bits), since numpy has no bf16 type.  The
reference cannot cast such a leaf back (ROADMAP C8); the port restores it
into a bf16 leaf bit for bit.

Leaves are saved as whole tensors.  They restore whole onto one device
(``device=``), or, with ``mesh`` (a ``launch.mesh.RankMesh``) and
``specs``, as the rank's own blocks (``dist.sharding.local_shard``), the
counterpart of the reference's ``NamedSharding`` placement: each rank
reads its block of each leaf's file (memory-mapped) and nothing else."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.dist.sharding import local_shard
from repro_torch.train.tree import flatten, treedef_str, unflatten

MANIFEST = "manifest.json"
COMMITTED = "COMMITTED"
# the numpy dtype a bf16 leaf is stored as
_BF16_RECORD = np.dtype("V2")


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _to_numpy(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _as_tensor(arr: np.ndarray) -> torch.Tensor:
    """The array as a tensor over the same memory (bf16 records as bf16)."""
    if arr.dtype == _BF16_RECORD:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_tensor(arr: np.ndarray, like, device) -> torch.Tensor:
    arr = np.array(arr, order="C")  # keeps a 0-d leaf 0-d
    return _as_tensor(arr).to(device=device, dtype=like.dtype)


def save_checkpoint(root: str, step: int, tree) -> str:
    """Two-phase atomic save of ``tree`` as step ``step``.  Returns the final
    directory."""
    final = os.path.join(root, f"step_{step:010d}")
    tmp = os.path.join(root, f".tmp-step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves, _ = flatten(tree)
    manifest = {"step": step, "n_leaves": len(leaves), "treedef": treedef_str(tree)}
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(tmp, _leaf_name(i)), _to_numpy(leaf))
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    # commit marker written last; rename is atomic on POSIX
    with open(os.path.join(tmp, COMMITTED), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_checkpoints(root: str) -> list:
    """Sorted (step, path) of the committed checkpoints under ``root``."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        full = os.path.join(root, name)
        if name.startswith("step_") and os.path.exists(os.path.join(full, COMMITTED)):
            out.append((int(name.split("_")[1]), full))
    return sorted(out)


def latest_checkpoint(root: str):
    """(step, path) of the newest committed checkpoint, or None."""
    cps = list_checkpoints(root)
    return cps[-1] if cps else None


def restore_checkpoint(path: str, like_tree, device=None, mesh=None, specs=None):
    """(tree, step): the checkpoint at ``path`` in the structure, shapes and
    dtypes of ``like_tree`` (tensors, ``meta`` tensors too), each leaf on
    ``device``, by default its ``like_tree`` leaf's (the card for a
    ``meta`` leaf; ``mesh.device`` with a mesh).  With ``mesh`` and
    ``specs`` (a spec tree shaped as ``like_tree``; ``like_tree`` holds the
    global shapes) each leaf is this rank's block by its spec.  Raises
    ValueError where the leaf count or a shape differs."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    leaves, _ = flatten(like_tree)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"{path}: {manifest['n_leaves']} leaves, the tree has {len(leaves)}: "
                         "tree structure changed")
    if (mesh is None) != (specs is None):
        raise ValueError("restore_checkpoint takes mesh and specs together")
    if mesh is not None and device is None:
        device = mesh.device
    fixed = None if device is None else resolve_device(device)
    spec_leaves = flatten(specs)[0] if specs is not None else [None] * len(leaves)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for a tree of {len(leaves)} leaves")
    coords = dict(zip(mesh.axis_names, mesh.coords)) if mesh is not None else None
    restored = []
    for i, (like, spec) in enumerate(zip(leaves, spec_leaves)):
        # a rank maps the file and copies its block alone ("c": private pages)
        arr = np.load(os.path.join(path, _leaf_name(i)), mmap_mode="c" if mesh else None)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{path}: leaf {i} has shape {arr.shape}, the tree's "
                             f"{tuple(like.shape)}")
        dev = fixed or (resolve_device("cuda") if like.device.type == "meta" else like.device)
        if mesh is None:
            restored.append(_to_tensor(arr, like, dev))
            continue
        block = local_shard(_as_tensor(arr), spec, mesh.shape, coords)
        restored.append(block.to(device=dev, dtype=like.dtype, copy=True))
    return unflatten(like_tree, restored), manifest["step"]


def prune_checkpoints(root: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    cps = list_checkpoints(root)
    for _, path in cps[:-keep]:
        shutil.rmtree(path)
