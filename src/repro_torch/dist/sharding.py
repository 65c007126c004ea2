"""Partition specs and the docs axis of the sharded retrieval service
(counterpart of ``repro.dist.sharding``).

Partition specs.  Every spec of the registry is decided here, by the
reference's rules on a ``launch.mesh.Mesh`` (or a rank mesh).  A spec is a
``PartitionSpec``: a tuple with one entry per leading tensor dimension, an
axis name, a tuple of names or ``None``, as JAX's is (a one-name tuple is
that name).  The last mesh axis, ``model``, is tensor parallel; every axis
before it is data parallel.  Every rule is divisibility-guarded, so the
same rules hold on the (1, 1) host mesh and on both production meshes:

* LM parameters: Megatron tensor parallelism over ``model`` (head axes,
  the FFN's hidden dimension, the expert axis, the vocab); routers stay
  replicated (``_moe_ffn_ep`` needs them whole);
* ZeRO (``zero_spec_for``): the data axes on the largest free dimension
  they divide, on the optimizer's moments always and on the parameters
  where the registry turns FSDP on;
* KV caches: batch over data, KV heads over model;
* recsys: tables of 2^16 rows or more row-sharded over model, the rest
  replicated.

``local_shard`` cuts one rank's block of a global tensor by its spec; the
multi-rank steps cut their inputs with it.

Docs axis.  Documents are split into contiguous shards (``doc_shard_bounds``); each
shard indexes its own sub-collection (``core.suffix.subcollection``) and
the service merges the shards' answers exactly.

Placement.  The reference places every shard's index leaves replicated on
every device of its ``docs`` mesh (its module docstring, "Placement
note"), so each device holds every shard's stack.  The counterpart on one
card is every shard's stack on that card: the port's docs mesh is the
shard count and one device, and needs no device per shard.  Placing shard
s on ``cuda:s`` over ``torch.distributed`` is later work.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common import resolve_device
from repro_torch.train.tree import map_leaves

DOCS_AXIS = "docs"


@dataclasses.dataclass(frozen=True)
class DocsMesh:
    """A 1-D ``docs`` mesh: ``n_shards`` document shards, every shard's
    index stack on ``device``."""

    n_shards: int
    device: torch.device


def make_docs_mesh(n_shards: int, device="cuda") -> DocsMesh:
    """The docs mesh of ``n_shards`` shards on ``device`` (the card unless
    the caller asks for the CPU)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return DocsMesh(n_shards=int(n_shards), device=resolve_device(device))


def docs_mesh_size(mesh: DocsMesh) -> int:
    return mesh.n_shards


def doc_shard_bounds(d: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous document ranges [dlo, dhi) per shard, balanced to within
    one document.  Every shard owns at least one document."""
    if n_shards > d:
        raise ValueError(
            f"n_shards={n_shards} > d={d}: every shard must own >= 1 document"
        )
    base, extra = divmod(d, n_shards)
    bounds = []
    lo = 0
    for s in range(n_shards):
        hi = lo + base + (1 if s < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


# ---------------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry per leading tensor dimension: the mesh axis it shards
    over, a tuple of axes, or ``None`` (replicated); the trailing
    dimensions not named are replicated.  A one-axis tuple is stored as
    its axis, as JAX's ``PartitionSpec`` stores it, so specs compare equal
    entry for entry with the reference's."""

    def __new__(cls, *entries):
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)
        return super().__new__(cls, norm)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Roles of the mesh axes: ``dp`` (a tuple: every data axis), ``mdl``
    (the tensor-parallel axis), ``all_axes`` in mesh order."""

    dp: tuple
    mdl: str
    all_axes: tuple


def axes_for_mesh(mesh) -> MeshAxes:
    names = tuple(mesh.axis_names)
    mdl = "model" if "model" in names else names[-1]
    dp = tuple(a for a in names if a != mdl)
    if not dp:
        dp = (mdl,)  # a one-axis mesh: data parallelism is the model axis of size 1
    return MeshAxes(dp=dp, mdl=mdl, all_axes=names)


def dp_size(mesh, axes: MeshAxes) -> int:
    return int(math.prod(mesh.shape[a] for a in axes.dp))


def _norm(spec, ndim: int) -> list:
    """The spec's entries padded with ``None`` to the tensor's rank."""
    entries = list(spec) if spec is not None else []
    return entries + [None] * (ndim - len(entries))


def _axis_if(mesh, axis: str, dim: int):
    return axis if dim % mesh.shape[axis] == 0 else None


def _dp_entry(axes: MeshAxes):
    return tuple(axes.dp) if len(axes.dp) > 1 else axes.dp[0]


def spec_axes(spec) -> tuple:
    """The mesh axes a spec shards over, in its entries' order."""
    return tuple(ax for entry in spec if entry is not None
                 for ax in (entry if isinstance(entry, tuple) else (entry,)))


def spec_dims(spec, ndim: int, mesh) -> tuple:
    """(the dimension a spec shards over ``model``, the one it shards over
    the data axes), each None where it has none.  The data entry must name
    every data axis of the mesh (the ``data`` group folds them all)."""
    md = dd = None
    for i, entry in enumerate(_norm(spec, ndim)):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        if mesh.model_axis in names:
            if len(names) != 1:
                raise ValueError(f"spec {spec}: the model axis shares a dimension")
            md = i
        else:
            if tuple(names) != tuple(mesh.dp_axes):
                raise ValueError(f"spec {spec}: dimension {i} is over {names}, not over every "
                                 f"data axis {mesh.dp_axes}")
            dd = i
    return md, dd


def zero_spec_for(spec, shape: tuple, axes: MeshAxes, dpn: int):
    """``spec`` with the data axes on the largest still-unsharded dimension
    that the data degree ``dpn`` divides (the last of equal ones);
    unchanged when ``dpn`` is 1, when a data axis already shards a
    dimension, or when no dimension qualifies."""
    if dpn <= 1:
        return spec
    entries = _norm(spec, len(shape))
    if set(spec_axes(entries)) & set(axes.dp):
        return spec
    best = -1
    for i, (entry, dim) in enumerate(zip(entries, shape)):
        if entry is None and dim % dpn == 0 and (best < 0 or dim >= shape[best]):
            best = i
    if best < 0:
        return spec
    entries[best] = _dp_entry(axes)
    return P(*entries)


#: blocks/pos* leaf -> the dimension (of the stacked [n_groups, ...] layout)
#: that shards over the model axis; -1: replicated
_LM_BLOCK_TP_DIM = {
    "attn_norm": -1,
    "ffn_norm": -1,
    "wq": 2,        # [G, d, H, dh]   heads
    "wk": 2,        # [G, d, K, dh]   kv heads
    "wv": 2,
    "wo": 1,        # [G, H, dh, d]   heads
    "w_gate": 2,    # [G, d, f]       hidden columns
    "w_up": 2,
    "w_down": 1,    # [G, f, d]       hidden rows
    "ws_gate": 2,   # shared expert: the dense FFN's layout
    "ws_up": 2,
    "ws_down": 1,
    "router": -1,   # replicated (expert parallelism routes on every rank)
    "we_gate": 1,   # [G, E, d, f]    expert axis
    "we_up": 1,
    "we_down": 1,   # [G, E, f, d]
}


def lm_param_specs(cfg, axes: MeshAxes, mesh, params_abs) -> dict:
    """Specs of a ``models.transformer`` parameter tree (``params_abs``:
    tensors or ``meta`` tensors of its shapes)."""
    mdl = axes.mdl

    def block_spec(name, ab):
        tp_dim = _LM_BLOCK_TP_DIM.get(name, -1)
        entries = [None] * ab.dim()
        if tp_dim >= 0:
            entries[tp_dim] = _axis_if(mesh, mdl, ab.shape[tp_dim])
        return P(*entries)

    specs = {
        "embed": P(_axis_if(mesh, mdl, params_abs["embed"].shape[0]), None),
        "final_norm": P(),
        "blocks": {pos: {name: block_spec(name, ab) for name, ab in leaves.items()}
                   for pos, leaves in params_abs["blocks"].items()},
    }
    if "lm_head" in params_abs:
        specs["lm_head"] = P(None, _axis_if(mesh, mdl, params_abs["lm_head"].shape[1]))
    return specs


def lm_batch_specs(axes: MeshAxes) -> dict:
    dp = _dp_entry(axes)
    return {"tokens": P(dp, None), "labels": P(dp, None)}


def lm_cache_specs(cfg, axes: MeshAxes, batch: int, mesh) -> dict:
    """Specs of ``init_cache``'s {pos*: {k, v}} of [G, B, S, K, Dh]."""
    dp = _dp_entry(axes) if batch % dp_size(mesh, axes) == 0 else None
    spec = P(None, dp, None, _axis_if(mesh, axes.mdl, cfg.n_kv_heads), None)
    return {f"pos{p}": {"k": spec, "v": spec} for p in range(cfg.period)}


def nequip_batch_specs(axes: MeshAxes, shard: bool = True) -> dict:
    """Node and edge sharding over every axis (a graph has no tensor
    dimension)."""
    if not shard:
        return {k: P() for k in ("node_feat", "edge_index", "edge_vec", "graph_id", "energy")}
    alla = axes.all_axes if len(axes.all_axes) > 1 else axes.all_axes[0]
    return {
        "node_feat": P(alla, None),
        "edge_index": P(None, alla),
        "edge_vec": P(alla, None),
        "graph_id": P(alla),
        "energy": P(),
    }


def recsys_param_specs(params_abs, axes: MeshAxes, mesh, row_threshold: int = 1 << 16):
    """Tables of ``row_threshold`` rows or more row-sharded over the model
    axis; every other leaf replicated."""
    def spec(ab):
        if ab.dim() == 2 and ab.shape[0] >= row_threshold:
            return P(_axis_if(mesh, axes.mdl, ab.shape[0]), None)
        return P()

    return map_leaves(spec, params_abs)


def opt_state_specs(param_specs, params_abs, axes: MeshAxes, dpn: int) -> dict:
    """The moments: each parameter's spec with the data axes added by
    ``zero_spec_for`` (ZeRO-1); the step replicated.  The layout of
    ``train.optimizer.adamw_init``'s {m, v, step}."""
    mspecs = map_leaves(lambda spec, ab: zero_spec_for(spec, tuple(ab.shape), axes, dpn),
                        param_specs, params_abs)
    return {"m": mspecs, "v": mspecs, "step": P()}


def shard_count(spec, mesh) -> int:
    """Over how many ranks a tensor of this spec is split."""
    return math.prod(mesh.shape[a] for a in spec_axes(spec or ()))


def local_shard(x: torch.Tensor, spec, mesh_shape: dict, coords: dict) -> torch.Tensor:
    """The block of ``x`` that the rank at ``coords`` (axis name ->
    coordinate) holds under ``spec`` on a mesh of ``mesh_shape`` (axis name
    -> size): each sharded dimension cut into equal blocks over its axes,
    the first axis of an entry the slowest.  A view of ``x``.  Raises where
    an axis does not divide its dimension (the reference's specs never ask
    for padding of a sharded input)."""
    entries = _norm(spec, x.dim())
    if len(entries) > x.dim():
        raise ValueError(f"spec {spec} has more entries than a {x.dim()}-d tensor")
    for dim, entry in enumerate(entries):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(mesh_shape[a] for a in names)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                             f"{names} ({n} ranks)")
        idx = 0
        for a in names:
            idx = idx * mesh_shape[a] + coords[a]
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x


def from_shards(blocks, spec, mesh) -> torch.Tensor:
    """The global tensor whose ``local_shard`` at each rank of ``mesh`` (a
    ``launch.mesh.Mesh``; ``blocks[r]`` the block of rank r, row-major
    coordinates) is that block: the inverse of ``local_shard``."""
    first = blocks[0]
    entries = _norm(spec, first.dim())
    shape = list(first.shape)
    for dim, entry in enumerate(entries):
        if entry is not None:
            shape[dim] *= shard_count(P(entry), mesh)
    out = first.new_empty(shape)
    for r, block in enumerate(blocks):
        coords = dict(zip(mesh.axis_names, mesh.coords(r)))
        local_shard(out, spec, mesh.shape, coords).copy_(block)
    return out
