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
collective bytes.  For the layout the port runs over several ranks,
``tp_train_bytes`` counts the bytes one rank sends in one
``dist.step.tp_train_step`` from the cell's shapes and specs, collective by
collective, as ``dist.collectives`` counts them in ``mesh.traffic``.
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

    tp = mesh.shape[mesh.model_axis]
    dp = math.prod(mesh.shape[a] for a in mesh.dp_axes)
    n = tp * dp
    B, S = batch
    D, dh = cfg.d_model, cfg.head_dim
    act, pb = cfg.act_dtype.itemsize, cfg.param_dtype.itemsize
    shapes = param_shapes(cfg)
    tokens = B * S

    def ag(nbytes, k):
        return int(nbytes * (k - 1))

    def a2a(nbytes, k):
        return int(nbytes * (k - 1) / k)

    def fsdp(shape, spec, groups=0):
        """A leaf FSDP shards: its gathers and its gradient's
        reduce-scatter; a block leaf (``groups``: its group count) is
        gathered a group at a time, twice a group under the checkpoint."""
        md, dd = spec_dims(spec, len(shape), mesh)
        if dd is None:
            return 0
        full = math.prod(shape) // max(groups, 1) // (tp if md is not None else 1) * pb
        per = ag(full // dp, dp) * (2 if groups else 1) + a2a(full, dp)
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
            layer += 6 * a2a(cfg.moe.n_experts * cap * D * act, tp)   # 2 exchanges x 3
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
    roles = set()
    for shape, ps, ms in zip(flatten(shapes)[0], flatten(pspecs)[0], flatten(mspecs)[0]):
        shape = tuple(shape)
        pmd, pdd = spec_dims(ps, len(shape), mesh)
        mmd, mdd = spec_dims(ms, len(shape), mesh)
        local = math.prod(shape) // (tp if pmd is not None else 1) // (dp if pdd is not None else 1)
        if pdd is None and mdd is not None:
            total += a2a(local * pb, dp) + ag(local // dp * pb, dp)   # reduce-scatter, gather
        elif pdd is None and dp > 1:
            total += _ring(local * 4, dp)
        roles.add(("all" if mmd is not None and mdd is not None else "model"
                   if mmd is not None else "data" if mdd is not None else None))
    group = {"all": n, "model": tp, "data": dp}
    total += sum(_ring(4, group[r]) for r in roles if r is not None and group[r] > 1)
    return total
