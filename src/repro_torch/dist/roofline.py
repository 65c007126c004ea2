"""Roofline accounting on NVIDIA H100 constants (counterpart of
``repro.dist.roofline``'s ``RooflineTerms`` and ``roofline_terms``).

``roofline_terms`` combines a cell's analytic FLOP and byte models (the
registry's ``meta``) with its collective traffic into three terms,
compute, memory and interconnect, each the least time the work could take
on ``chips`` cards, and names the largest.  The constants are one H100
SXM's published peaks (NVIDIA's data sheet, dense, at the 700 W limit):
989.4e12 bf16 FLOP/s on the tensor cores, 3.35e12 B/s of HBM3, and
450e9 B/s a direction of NVLink 4 for the collective term.

The reference sizes its collectives by parsing XLA's HLO text
(``parse_collectives``); the port has no HLO.  A one-card cell moves no
collective bytes.  For each per-rank program the port runs over several
ranks, one function counts the bytes one rank sends in one call from the
cell's shapes and specs, collective by collective, as
``dist.collectives`` adds them to ``mesh.traffic`` (an all-to-all sends
(n-1)/n of its input, an all-gather n-1 times its block, a ring
all-reduce 2(n-1)/n of its f32 input; each call's bytes truncated to an
integer on its own):

* ``tp_train_bytes``: one ``dist.step.tp_train_step`` of an LM;
* ``tp_prefill_bytes``, ``tp_decode_bytes``: ``models.transformer``'s
  ``forward_prefill`` and one ``forward_decode`` step on a
  ``dist.tp.Layout``;
* ``recsys_bytes``: a recsys cell's serve call, retrieval or ZeRO-1
  training step on ``models.recsys.RowBlock`` tables;
* ``gnn_bytes``: NequIP's partitioned step, or the gathered dense step of
  a cell whose specs split its graph (0 where nothing is split).

These are the port's own layouts' bytes.  XLA's partitioner picks other
collectives for the reference, so its HLO counts differ.
"""

from __future__ import annotations

import dataclasses
import math

#: one H100 SXM: dense bf16 tensor-core FLOP/s
H100_PEAK_BF16_FLOPS = 989.4e12
#: one H100 SXM: HBM3 bytes/s
H100_PEAK_HBM_BPS = 3.35e12
#: NVLink 4 on an H100 SXM: bytes/s in one direction (900 GB/s both ways)
H100_NVLINK_BPS = 450e9


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    analytic_flops: float
    useful_ratio: float

    def row(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(meta: dict, chips: int, collective_bytes: float, raw_flops: float = 0.0,
                   raw_bytes: float = 0.0) -> RooflineTerms:
    """The three terms of one cell.  ``meta``: the registry's analytic
    model (``model_flops``, ``analytic_flops``, ``analytic_bytes``);
    ``collective_bytes``: bytes each card sends; ``raw_flops`` and
    ``raw_bytes``: a measured count where one exists (the larger of it and
    the analytic one is used, as the reference does with XLA's cost
    analysis).  FLOPs and bytes split evenly over ``chips``; the
    collective bytes are already per card."""
    chips = max(1, int(chips))
    model_flops = float(meta.get("model_flops", 0.0))
    flops = max(float(meta.get("analytic_flops", 0.0)), float(raw_flops))
    bytes_ = max(float(meta.get("analytic_bytes", 0.0)), float(raw_bytes))

    compute_s = flops / (chips * H100_PEAK_BF16_FLOPS)
    memory_s = bytes_ / (chips * H100_PEAK_HBM_BPS)
    collective_s = float(collective_bytes) / H100_NVLINK_BPS

    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops / flops if flops > 0 else 0.0
    return RooflineTerms(compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
                         dominant=dominant, model_flops=model_flops, analytic_flops=flops,
                         useful_ratio=useful)


def _ring(nbytes: float, n: int) -> int:
    """An all-reduce's bytes sent a rank (a ring: 2(n-1)/n of the input)."""
    return int(nbytes * 2 * (n - 1) / n)


def _ag(nbytes: int, n: int) -> int:
    """An all-gather's bytes sent a rank: n-1 times its block."""
    return int(nbytes * (n - 1))


def _a2a(nbytes: int, n: int) -> int:
    """An all-to-all's (or a reduce-scatter's exchange's) bytes sent a
    rank: (n-1)/n of its input."""
    return int(nbytes * (n - 1) / n)


def _mesh_sizes(mesh) -> tuple:
    """(tp, dp, n): the ``model`` group's size, the ``data`` group's (every
    data axis) and the mesh's."""
    tp = mesh.shape[mesh.model_axis]
    dp = math.prod(mesh.shape[a] for a in mesh.dp_axes)
    return tp, dp, tp * dp


def _zero1_bytes(mesh, leaves, pspecs, mspecs) -> int:
    """What ``dist.step.mean_over_data`` and ``zero1_train_step`` send
    after the backward, ``leaves`` being each parameter's (global shape,
    itemsize) in tree order: a leaf whose moments ZeRO-1 shards over
    ``data`` is reduce-scattered onto them and its updated block gathered
    back, any other not sharded over ``data`` all-reduced (in f32; a leaf
    FSDP shards was summed by its gather's backward); then the clipping
    norm's f32 sums, one for each group the moments' specs split leaves
    over."""
    from repro_torch.dist.sharding import spec_dims

    tp, dp, n = _mesh_sizes(mesh)
    total, roles = 0, set()
    for (shape, isz), ps, ms in zip(leaves, pspecs, mspecs):
        pmd, pdd = spec_dims(ps, len(shape), mesh)
        mmd, mdd = spec_dims(ms, len(shape), mesh)
        local = math.prod(shape) // (tp if pmd is not None else 1) // (dp if pdd is not None else 1)
        if pdd is None and mdd is not None:
            total += _a2a(local * isz, dp) + _ag(local // dp * isz, dp)
        elif pdd is None and dp > 1:
            total += _ring(local * 4, dp)
        roles.add(("all" if mmd is not None and mdd is not None else "model"
                   if mmd is not None else "data" if mdd is not None else None))
    group = {"all": n, "model": tp, "data": dp}
    return total + sum(_ring(4, group[r]) for r in roles if r is not None and group[r] > 1)


def tp_train_bytes(cfg, mesh, pspecs, mspecs, batch: tuple) -> int:
    """Bytes one rank sends in one ``dist.step.tp_train_step`` of ``cfg`` on
    ``mesh`` (a ``Mesh`` or a ``RankMesh``), parameters in ``pspecs``,
    moments in ``mspecs``, a data shard of ``batch`` = (rows, positions).
    Every sum moves f32; a gather, a reduce-scatter and an exchange move
    their tensor's own dtype.  A checkpointed group runs its forward's
    collectives twice (the forward and the backward's recompute), all but
    its closing row-parallel sum, after which the recompute has nothing
    left to save."""
    from repro_torch.dist.sharding import spec_dims
    from repro_torch.models.transformer import moe_capacity, param_shapes
    from repro_torch.train.tree import flatten

    tp, dp, n = _mesh_sizes(mesh)
    B, S = batch
    D, dh = cfg.d_model, cfg.head_dim
    act, pb = cfg.act_dtype.itemsize, cfg.param_dtype.itemsize
    shapes = param_shapes(cfg)
    tokens = B * S

    def fsdp(shape, spec, groups=0):
        """A leaf FSDP shards: its gathers and its gradient's
        reduce-scatter; a block leaf (``groups``: its group count) is
        gathered a group at a time, twice a group under the checkpoint."""
        md, dd = spec_dims(spec, len(shape), mesh)
        if dd is None:
            return 0
        full = math.prod(shape) // max(groups, 1) // (tp if md is not None else 1) * pb
        per = _ag(full // dp, dp) * (2 if groups else 1) + _a2a(full, dp)
        return per * max(groups, 1)

    total = 0
    for key in ("embed", "final_norm", "lm_head"):
        if key in shapes:
            total += fsdp(shapes[key], pspecs[key])
    emb_md = spec_dims(pspecs["embed"], 2, mesh)[0]
    if emb_md == 0:
        total += _ring(tokens * D * 4, tp)
    G = cfg.n_groups
    for pos, leaves in shapes["blocks"].items():
        sp = pspecs["blocks"][pos]
        for name, shape in leaves.items():
            total += fsdp(shape, sp[name], groups=G)
        split = {name: spec_dims(sp[name], len(shape), mesh)[0] is not None
                 for name, shape in leaves.items()}
        layer = 0
        if split["wq"]:
            layer += _ring(tokens * D * 4, tp)                     # f on h (backward)
            layer += 2 * _ring(tokens * D * 4, tp)                 # psum after wo, twice
            if not split["wk"]:
                layer += 2 * _ring(tokens * cfg.n_kv_heads * dh * 4, tp)  # f on k, v
        ffn_split = split.get("ws_gate" if cfg.moe else "w_gate", False)
        if ffn_split:
            layer += 3 * _ring(tokens * D * 4, tp)                 # f, then psum twice
        if cfg.moe:
            cap = moe_capacity(cfg, tokens)
            layer += 6 * _a2a(cfg.moe.n_experts * cap * D * act, tp)   # 2 exchanges x 3
            layer += 3 * _ring(4, n)                               # aux mean, twice + backward
        total += G * layer
        if pos == f"pos{cfg.period - 1}" and ffn_split:
            # the recompute stops once the last tensor the backward saved is
            # back (torch's checkpoint early stop): a group's closing psum
            # runs once
            total -= G * _ring(tokens * D * 4, tp)
    head_md = (spec_dims(pspecs["lm_head"], 2, mesh)[0] == 1 if "lm_head" in shapes
               else emb_md == 0)
    if head_md:
        rows = B * (S - 1)
        total += _ring(rows * D * 4, tp)
        cb = min(512, S - 1)
        for lo in range(0, S - 1, cb):
            total += 3 * _ring(B * min(cb, S - 1 - lo) * 4, tp)
    total += _ring(4, dp)                                          # the loss's mean
    leaves = [(tuple(shape), pb) for shape in flatten(shapes)[0]]
    return total + _zero1_bytes(mesh, leaves, flatten(pspecs)[0], flatten(mspecs)[0])


def _lm_serve_bytes(cfg, mesh, pspecs, rows: int, positions: int, decode: bool) -> int:
    """One forward of ``rows`` x ``positions`` tokens on a rank's
    ``dist.tp.Layout`` (no backward, so Megatron's *f* sends nothing):
    the FSDP gathers over ``data`` (``embed``, ``final_norm`` and
    ``lm_head`` once, each group's leaves once), the vocab-sharded
    lookup's sum, and per layer the row-parallel sums after ``wo`` and the
    FFN's (the shared expert's) down projection.  An MoE layer adds, in
    prefill, ``_moe_ffn_ep``'s two exchanges of the [E, cap, D] buffer over
    ``model`` and its auxiliary loss's f32 mean over every rank; in decode,
    the chosen expert's row summed over ``model``.  The head returns the
    rank's vocab block and sends nothing."""
    from repro_torch.dist.sharding import spec_dims
    from repro_torch.models.transformer import moe_capacity, param_shapes

    tp, dp, n = _mesh_sizes(mesh)
    D, pb, act = cfg.d_model, cfg.param_dtype.itemsize, cfg.act_dtype.itemsize
    shapes = param_shapes(cfg)
    T = rows * positions
    G = cfg.n_groups

    def gathered(shape, spec, groups=1):
        md, dd = spec_dims(spec, len(shape), mesh)
        if dd is None:
            return 0
        local = math.prod(shape) // groups // (tp if md is not None else 1) // dp
        return groups * _ag(local * pb, dp)

    total = sum(gathered(shapes[k], pspecs[k]) for k in ("embed", "final_norm", "lm_head")
                if k in shapes)
    if spec_dims(pspecs["embed"], 2, mesh)[0] == 0:
        total += _ring(T * D * 4, tp)
    row = _ring(T * D * 4, tp)
    for pos, leaves in shapes["blocks"].items():
        sp = pspecs["blocks"][pos]
        total += sum(gathered(shape, sp[name], G) for name, shape in leaves.items())
        split = {name: spec_dims(sp[name], len(shape), mesh)[0] is not None
                 for name, shape in leaves.items()}
        layer = row if split["wo"] else 0
        if cfg.moe:
            if decode:
                layer += row if split["we_gate"] else 0
            else:
                cap = moe_capacity(cfg, T)
                layer += 2 * _a2a(cfg.moe.n_experts * cap * D * act, tp) + _ring(4, n)
            layer += row if split.get("ws_down", False) else 0
        else:
            layer += row if split["w_down"] else 0
        total += G * layer
    return total


def tp_prefill_bytes(cfg, mesh, pspecs, batch: tuple) -> int:
    """Bytes one rank sends in ``models.transformer.forward_prefill`` of
    ``cfg`` on ``mesh`` (a ``Mesh`` or a ``RankMesh``), parameters in
    ``pspecs``, the rank's ``batch`` = (rows, positions) of the prompt
    (``_lm_serve_bytes``)."""
    return _lm_serve_bytes(cfg, mesh, pspecs, *batch, decode=False)


def tp_decode_bytes(cfg, mesh, pspecs, rows: int) -> int:
    """Bytes one rank sends in one ``forward_decode`` step of its ``rows``
    sequences at any position (no collective depends on it)."""
    return _lm_serve_bytes(cfg, mesh, pspecs, rows, 1, decode=True)


def _recsys_lookups(kind: str, cfg, rows: int) -> list:
    """The row lookups of one call of ``models.recsys``'s entry point for
    ``kind`` (``"serve"``, ``"train"``: ``rows`` requests; ``"retrieval"``:
    ``rows`` candidates and one user), in call order: (table, ids)."""
    from repro_torch.models import recsys as R

    if isinstance(cfg, R.SASRecConfig):
        S = cfg.seq_len
        table = "item_emb"
        counts = {"serve": [rows * S, rows], "train": [rows * S] * 3,
                  "retrieval": [S, rows]}[kind]
        return [(table, c) for c in counts]
    F = cfg.n_sparse
    tables = ("emb", "lin") if isinstance(cfg, R.FMConfig) else ("emb",)
    if kind != "retrieval":
        return [(t, rows * F) for t in tables]
    # AutoInt looks up the user's every field; FM and DLRM all but the candidates'
    user = F if isinstance(cfg, R.AutoIntConfig) else F - 1
    return [(t, user) for t in tables] + [(t, rows) for t in tables]


def recsys_bytes(kind: str, cfg, mesh, params, pspecs, rows: int, mspecs=None) -> int:
    """Bytes one rank sends in one call of a recsys cell's step on
    ``mesh``: ``params`` the cell's parameter tree (tensors or ``meta``
    tensors of the global shapes and dtypes), ``pspecs`` its specs,
    ``rows`` the rank's requests (``"serve"``, ``"train"``) or candidates
    (``"retrieval"``).  A lookup in a table row-sharded over ``model``
    (``models.recsys.RowBlock``) sums its f32 rows over ``model``; a
    retrieval's (``spread``) gathers the group's int32 ids and
    reduce-scatters the looked-up rows in the table's dtype.  ``"train"``
    adds the loss's mean over ``data`` and the ZeRO-1 step's collectives
    (``mspecs``: the moments' specs)."""
    from repro_torch.dist.sharding import spec_dims
    from repro_torch.train.tree import flatten

    tp, dp, _ = _mesh_sizes(mesh)
    total = 0
    for key, ids in _recsys_lookups(kind, cfg, rows):
        table = params[key]
        if spec_dims(pspecs[key], 2, mesh)[0] != 0:
            continue
        width = table.shape[1]
        if kind == "retrieval":
            total += _ag(ids * 4, tp) + _a2a(tp * ids * width * table.element_size(), tp)
        else:
            total += _ring(ids * width * 4, tp)
    if kind == "train":
        total += _ring(4, dp)
        leaves = [(tuple(x.shape), x.element_size()) for x in flatten(params)[0]]
        total += _zero1_bytes(mesh, leaves, flatten(pspecs)[0], flatten(mspecs)[0])
    return total


def _unshard_bytes(nbytes: int, spec, mesh) -> int:
    """What ``dist.step.unshard_tree`` sends for one leaf of ``nbytes``
    global bytes: each sharded dimension gathered in turn, the block
    growing by each group's size."""
    from repro_torch.dist.sharding import shard_count, spec_axes

    local, total = nbytes // shard_count(spec, mesh), 0
    for entry in spec:
        if entry is None:
            continue
        k = math.prod(mesh.shape[a] for a in spec_axes((entry,)))
        total += _ag(local, k)
        local *= k
    return total


def gnn_bytes(mesh, params, batch, bspecs) -> int:
    """Bytes one rank sends in one training step of a NequIP cell on
    ``mesh``: ``params`` the parameter tree, ``batch`` the cell's inputs
    (global shapes), ``bspecs`` their specs.  The partitioned layout
    (``batch`` has ``export_idx``): each layer's halo gathered over every
    rank (``models.nequip.halo_bytes_per_layer``, a rank sending its
    exports n-1 times; layer 0 gathers s alone, 1 of 13 floats a channel)
    and reduce-scattered back in the backward, the energies' f32 sum, and
    each f32 gradient leaf summed over every rank.  Otherwise the gathers
    of the batch leaves the specs split (``dist.step.unshard_tree``), then
    the dense step on every rank, which sends nothing: 0 where nothing is
    split."""
    from repro_torch.models.nequip import halo_bytes_per_layer
    from repro_torch.train.tree import flatten

    n = mesh.size
    if n == 1:
        return 0
    if "export_idx" not in batch:
        return sum(_unshard_bytes(x.numel() * x.element_size(), bspecs[k], mesh)
                   for k, x in batch.items())
    C, L = params["embed_in"].shape[1], len(params["layers"])
    layer = halo_bytes_per_layer(n, batch["export_idx"].shape[0] // n, C) * (n - 1) // n
    halo = layer // 13 + (L - 1) * layer
    return (2 * halo + _ring(4 * batch["energy"].shape[0], n)
            + sum(_ring(x.numel() * 4, n) for x in flatten(params)[0]))
