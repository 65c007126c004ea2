"""The architectures and the cell registry (counterpart of
``repro.configs.registry``).

``ALL_ARCHS`` names the reference's ten architectures and
``get_arch_module`` returns each one's config module.  A *cell* is one
(architecture x input shape) entry of the 40-cell dry-run and roofline
matrix: its step function (train, prefill, decode, serve or retrieval)
through the port's own entry points, its abstract inputs (trees of
``meta`` tensors with the reference's global shapes and dtypes: nothing is
allocated), the partition specs of those inputs and of its outputs on the
given mesh (``in_specs``, ``out_specs``: the reference's, spec for spec,
by ``dist.sharding``'s rules), and its roofline metadata, the reference's
analytic FLOP and byte models number for number.

The mesh (``mesh=``, default the (1, 1) host mesh) is a ``launch.mesh
.Mesh`` or a ``RankMesh``.  On one rank every cell keeps its one-card
layout and step.  On more than one:

* an LM cell runs in the layout of its own ``in_specs`` (a
  ``dist.tp.Layout`` threaded through ``models.transformer``'s forward):
  the train step takes this rank's parameter blocks (tensor-parallel over
  ``model``, over the data axes too where FSDP is on), its moment blocks
  (ZeRO-1) and its data shard, the experts of an MoE model through the
  expert exchange (``dist.step.tp_train_step``); prefill and decode take the rank's parameter blocks,
  batch rows and cache block and return its block of the logits;
* a recsys cell runs on this rank's rows of every table its specs
  row-shard over ``model`` (``models.recsys.RowBlock``: a lookup masks the
  ids outside the block and sums over ``model``; a retrieval's candidates,
  sharded over every axis, gather the group's ids and reduce-scatter the
  rows back) and on its batch rows; the train step reduces the gradient
  over ``data`` into its ZeRO-1 moments (``dist.step.zero1_train_step``);
* ``minibatch_lg`` and ``ogb_products`` take the reference's partitioned
  layout (``edge_src``, ``edge_dst``, ``export_idx``; ``node_n // 8``
  halo exports a rank) and the partitioned step on this rank's blocks;
* ``molecule``, whose specs split nodes and edges over the ranks but
  which has no partitioned layout, gathers its blocks back into the whole
  graph (``dist.step.unshard_tree``) and runs the dense step on every
  rank: each holds the same loss and gradient, and no gradient is summed;
  ``full_graph_sm`` is replicated and keeps the one-card step;
* these steps run on a ``RankMesh`` only (a description has no process
  groups); every other cell's step runs whole wherever it is called.

The reference's layout hints are not run (the sequence-parallel residual,
context-parallel attention, DLRM's candidate sharding constraint in
retrieval): they leave values unchanged, and a per-rank program has no
global layout to hint at.

A decode cell's position is a host integer in the port
(``forward_decode``'s ``t``; ROADMAP C11).  Its abstract input is the
reference's int32 scalar; the step reads a real one with ``int(t)`` and
takes a ``meta`` one as the cache's last slot, S - 1.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import torch

from repro_torch.dist.sharding import (
    P,
    axes_for_mesh,
    dp_size,
    lm_batch_specs,
    lm_cache_specs,
    lm_param_specs,
    opt_state_specs,
    recsys_param_specs,
    spec_axes,
    zero_spec_for,
)
from repro_torch.launch.mesh import RankMesh, make_host_mesh
from repro_torch.models import nequip as nequip_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import AdamWConfig, adamw_update, opt_state_shapes
from repro_torch.train.tree import flatten, map_leaves, unflatten

_ARCH_MODULES = {
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "nequip": "repro_torch.configs.nequip",
    "fm": "repro_torch.configs.fm",
    "sasrec": "repro_torch.configs.sasrec",
    "autoint": "repro_torch.configs.autoint",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
}

ALL_ARCHS = tuple(_ARCH_MODULES)

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# GNN shapes: sizes padded up to multiples of 512 (and of 512 * edge_chunks)
# so that every array dimension shards evenly over the reference's meshes;
# padding is the data pipeline's (dummy isolated nodes, self-loop edges).
GNN_SHAPES = {
    "full_graph_sm": dict(
        kind="train", n_nodes=2708, n_edges=10556, d_feat=1433,
        n_graphs=1, edge_chunks=1, shard=False,
    ),
    "minibatch_lg": dict(
        kind="train", n_nodes=169_984, n_edges=169_984, d_feat=602,
        n_graphs=1, edge_chunks=4, shard=True, partitioned=True,
        note="1024 seeds x fanout 15-10, padded from 168,960 edges",
    ),
    "ogb_products": dict(
        kind="train", n_nodes=2_449_408, n_edges=61_865_984, d_feat=100,
        n_graphs=1, edge_chunks=8, shard=True, partitioned=True,
        note="padded from 2,449,029 nodes / 61,859,140 edges",
    ),
    "molecule": dict(
        kind="train", n_nodes=3840, n_edges=8192, d_feat=32,
        n_graphs=128, edge_chunks=1, shard=True,
    ),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

_FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}


def get_arch_module(arch_id: str):
    """The config module of ``arch_id`` (``config()``, ``reduced_config()``,
    ``ARCH_ID``, ``FAMILY``)."""
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown architecture {arch_id!r} (have {', '.join(ALL_ARCHS)})")
    return importlib.import_module(_ARCH_MODULES[arch_id])


ARCH_SHAPES = {arch: tuple(_FAMILY_SHAPES[get_arch_module(arch).FAMILY])
               for arch in ALL_ARCHS}


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: str
    kind: str
    step_fn: Callable
    abstract_args: tuple
    in_specs: tuple
    out_specs: Any
    meta: dict


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _params_total(params) -> int:
    return sum(leaf.numel() for leaf in flatten(params)[0])


def _maybe_axes(n: int, mesh, axes_tuple):
    """The longest prefix of ``axes_tuple`` whose sizes' product divides n
    (one name for a prefix of one), else None."""
    prod = 1
    usable = []
    for a in axes_tuple:
        prod *= mesh.shape[a]
        if n % prod:
            break
        usable.append(a)
    if not usable:
        return None
    return tuple(usable) if len(usable) > 1 else usable[0]


def _replicated(tree):
    return map_leaves(lambda _: P(), tree)


def _on_ranks(mesh, make_step):
    """``make_step()`` where ``mesh`` is a ``RankMesh``; else a step that
    raises (a description has no process groups to run over)."""
    if isinstance(mesh, RankMesh):
        return make_step()

    def step(*args):
        raise RuntimeError(f"this cell's step runs on the {mesh.size} ranks of a started "
                           "world: build it on init_rank_mesh's RankMesh")

    return step


def _train_step(loss_fn, opt_cfg: AdamWConfig):
    """(params, opt_state, batch) -> (new params, new state, loss): the
    loss and its gradients, then one AdamW update."""

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        new_params, new_opt = adamw_update(opt_cfg, params, grads, opt_state)
        return new_params, new_opt, loss

    return step


# ===========================================================================
# LM cells
# ===========================================================================


def _lm_attn_flops_per_layer_fwd(cfg, B, S, local: bool):
    s_eff = min(cfg.local_chunk, S) if local else S
    return 4.0 * B * S * s_eff * cfg.n_heads * cfg.head_dim


def _lm_meta(cfg: tf_mod.LMConfig, kind: str, B: int, S: int):
    n_act = cfg.active_param_count()
    n_tot = cfg.param_count()
    T = B * S
    n_local = len(cfg.local_positions) * cfg.n_groups
    n_global = cfg.n_layers - n_local
    attn_fwd = n_local * _lm_attn_flops_per_layer_fwd(cfg, B, S, True) + (
        n_global * _lm_attn_flops_per_layer_fwd(cfg, B, S, False)
    )
    wb = cfg.param_dtype.itemsize
    cache_bytes = (
        cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2  # bf16 k+v
    )
    if kind == "train":
        model_flops = 6.0 * n_act * T
        # fwd + bwd + full-remat recompute = 4x fwd matmul flops
        analytic_flops = 8.0 * n_act * T + 4.0 * attn_fwd
        analytic_bytes = (
            n_tot * (wb * 2 + 4 + 4)        # params r/w, grad, opt moments
            + T * cfg.d_model * cfg.n_layers * 12 * 2  # activation traffic
        )
    elif kind == "prefill":
        model_flops = 2.0 * n_act * T
        analytic_flops = 2.0 * n_act * T + attn_fwd
        analytic_bytes = n_tot * wb + cache_bytes + T * cfg.d_model * cfg.n_layers * 6 * 2
    else:  # decode
        # decode MoE computes all experts for the live tokens
        n_dec = n_tot if cfg.moe else n_act
        attn_dec = 4.0 * B * S * cfg.n_heads * cfg.head_dim * cfg.n_layers
        model_flops = 2.0 * n_act * B
        analytic_flops = 2.0 * n_dec * B + attn_dec
        analytic_bytes = n_dec * wb + cache_bytes
    return dict(
        model_flops=float(model_flops),
        analytic_flops=float(analytic_flops),
        analytic_bytes=float(analytic_bytes),
        scan_trips=cfg.n_groups,
        params_total=n_tot,
        params_active=n_act,
        tokens=T if kind != "decode" else B,
    )


def _lm_cell(arch_id, mod, shape_id, mesh, reduced):
    cfg = mod.reduced_config() if reduced else mod.config()
    axes = axes_for_mesh(mesh)
    info = LM_SHAPES[shape_id]
    B, S = info["batch"], info["seq"]
    kind = info["kind"]
    params_abs = tf_mod.init_params(cfg, None, device="meta")
    meta = _lm_meta(cfg, kind, B, S)
    pspecs = lm_param_specs(cfg, axes, mesh, params_abs)

    # FSDP: where tensor parallelism alone leaves more than 2 GiB of
    # parameters a device, every weight but the router takes the data axes
    needs_fsdp = cfg.param_count() * cfg.param_dtype.itemsize / mesh.shape[axes.mdl] > 2 * 2**30
    if needs_fsdp:
        dpn = dp_size(mesh, axes)
        leaves, paths = flatten(params_abs)
        pspecs = unflatten(pspecs, [
            spec if path[-1] == "router" else zero_spec_for(spec, tuple(ab.shape), axes, dpn)
            for spec, ab, path in zip(flatten(pspecs)[0], leaves, paths)])

    if kind == "train":
        opt_dtype = (torch.bfloat16 if getattr(mod, "OPT_MOMENT_DTYPE", "") == "bfloat16"
                     else torch.float32)
        opt_cfg = AdamWConfig(moment_dtype=opt_dtype)
        batch_abs = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}

        ospecs = opt_state_specs(pspecs, params_abs, axes, dp_size(mesh, axes))
        if mesh.size > 1:
            def make_step():
                from repro_torch.dist.step import tp_train_step

                return tp_train_step(cfg, opt_cfg, mesh, pspecs, ospecs["m"])

            step = _on_ranks(mesh, make_step)
        else:
            def loss_fn(params, batch):
                return tf_mod.forward_train(cfg, params, batch["tokens"], batch["labels"])

            step = _train_step(loss_fn, opt_cfg)
        return CellSpec(arch=arch_id, shape=shape_id, kind=kind, step_fn=step,
                        abstract_args=(params_abs, opt_state_shapes(params_abs, opt_cfg),
                                       batch_abs),
                        in_specs=(pspecs, ospecs, lm_batch_specs(axes)),
                        out_specs=(pspecs, ospecs, P()), meta=meta)

    cspecs = lm_cache_specs(cfg, axes, B, mesh)
    logits_spec = P(_maybe_axes(B, mesh, axes.dp), axes.mdl)
    if kind == "prefill":
        if mesh.size > 1:
            def make_prefill():
                from repro_torch.dist.tp import Layout

                return lambda params, tokens: tf_mod.forward_prefill(
                    cfg, params, tokens, layout=Layout(cfg, mesh, pspecs, params))

            step = _on_ranks(mesh, make_prefill)
        else:
            def step(params, tokens):
                return tf_mod.forward_prefill(cfg, params, tokens)

        return CellSpec(arch=arch_id, shape=shape_id, kind=kind, step_fn=step,
                        abstract_args=(params_abs, _meta((B, S), torch.int32)),
                        in_specs=(pspecs, P(axes.dp, None)), out_specs=(logits_spec, cspecs),
                        meta=meta)

    # decode
    if mesh.size > 1:
        def make_decode():
            from repro_torch.dist.tp import Layout

            return lambda params, token, cache, t: tf_mod.forward_decode(
                cfg, params, token, cache, int(t), layout=Layout(cfg, mesh, pspecs, params))

        step = _on_ranks(mesh, make_decode)
    else:
        def step(params, token, cache, t):
            pos = S - 1 if t.is_meta else int(t)
            return tf_mod.forward_decode(cfg, params, token, cache, pos)

    return CellSpec(
        arch=arch_id, shape=shape_id, kind=kind, step_fn=step,
        abstract_args=(params_abs, _meta((B,), torch.int32),
                       tf_mod.init_cache(cfg, B, S, device="meta"), _meta((), torch.int32)),
        in_specs=(pspecs, P(_maybe_axes(B, mesh, axes.dp)), cspecs, P()),
        out_specs=(logits_spec, cspecs), meta=meta)


# ===========================================================================
# GNN cells
# ===========================================================================


def _gnn_meta(cfg, info):
    N, E = info["n_nodes"], info["n_edges"]
    C = cfg.channels
    L = cfg.n_layers
    # per edge: radial MLP + ~10 tensor-product paths over (C, <=9) comps
    per_edge = 2 * (cfg.n_rbf * cfg.radial_hidden + cfg.radial_hidden * cfg.n_paths * C) + 140 * C
    # per node: 6 channel mixes over (1 + 3 + 9) components + gates
    per_node = 2 * C * C * 26 + 4 * C * C
    fwd = L * (E * per_edge + N * per_node) + 2 * N * cfg.d_feat_in * C
    model_flops = 3.0 * fwd  # fwd + bwd
    analytic_flops = 4.0 * fwd  # + remat-free but scan recompute margin
    msg_bytes = E * C * 13 * 4  # one chunk pass writes/read messages
    analytic_bytes = L * (2 * msg_bytes + N * C * 13 * 4 * 4)
    return dict(
        model_flops=float(model_flops),
        analytic_flops=float(analytic_flops),
        analytic_bytes=float(analytic_bytes),
        scan_trips=info["edge_chunks"],
        params_total=_params_total(nequip_mod.abstract_params(cfg)),
        params_active=0,
        tokens=N,
    )


def _gnn_cell(arch_id, mod, shape_id, mesh, reduced):
    info = GNN_SHAPES[shape_id]
    axes = axes_for_mesh(mesh)
    if reduced:
        cfg = mod.reduced_config()
        N, E, F, G = 64, 128, cfg.d_feat_in, 4
        chunks = 1
    else:
        cfg = mod.config(d_feat_in=info["d_feat"])
        N, E, F, G = info["n_nodes"], info["n_edges"], info["d_feat"], info["n_graphs"]
        chunks = info["edge_chunks"]
    params_abs = nequip_mod.abstract_params(cfg)
    opt_cfg = AdamWConfig()
    opt_abs = opt_state_shapes(params_abs, opt_cfg)
    pspecs, ospecs = _replicated(params_abs), _replicated(opt_abs)
    meta = _gnn_meta(cfg, info if not reduced else dict(n_nodes=N, n_edges=E, edge_chunks=chunks))

    if info.get("partitioned", False) and not reduced and mesh.size > 1:
        # the distributed-GNN layout: nodes and edges partitioned by the data
        # pipeline, fixed-size halo exports (1/8 of a node block)
        ndev = mesh.size
        xmax = max(1, N // ndev // 8)
        aspec = axes.all_axes if len(axes.all_axes) > 1 else axes.all_axes[0]
        batch_abs = {
            "node_feat": _meta((N, F), torch.float32),
            "edge_src": _meta((E,), torch.int32),
            "edge_dst": _meta((E,), torch.int32),
            "edge_vec": _meta((E, 3), torch.float32),
            "export_idx": _meta((ndev * xmax,), torch.int32),
            "graph_id": _meta((N,), torch.int32),
            "energy": _meta((G,), torch.float32),
        }
        bspecs = {k: P() if k == "energy" else P(aspec, None) if v.dim() == 2 else P(aspec)
                  for k, v in batch_abs.items()}

        def make_step():
            from repro_torch.dist.step import partitioned_train_step

            loss_fn = nequip_mod.partitioned_train_step_fn(cfg, mesh, G, n_edge_chunks=chunks)
            return partitioned_train_step(loss_fn, mesh, opt_cfg)

        return CellSpec(arch=arch_id, shape=shape_id, kind="train",
                        step_fn=_on_ranks(mesh, make_step),
                        abstract_args=(params_abs, opt_abs, batch_abs),
                        in_specs=(pspecs, ospecs, bspecs), out_specs=(pspecs, ospecs, P()),
                        meta=meta)

    batch_abs = {
        "node_feat": _meta((N, F), torch.float32),
        "edge_index": _meta((2, E), torch.int32),
        "edge_vec": _meta((E, 3), torch.float32),
        "graph_id": _meta((N,), torch.int32),
        "energy": _meta((G,), torch.float32),
    }
    if info.get("shard", True) and not reduced:
        node_ax = _maybe_axes(N, mesh, axes.all_axes)
        edge_ax = _maybe_axes(E, mesh, axes.all_axes)
        bspecs = {"node_feat": P(node_ax, None), "edge_index": P(None, edge_ax),
                  "edge_vec": P(edge_ax, None), "graph_id": P(node_ax), "energy": P()}
    else:
        bspecs = _replicated(batch_abs)

    def loss_fn(params, batch):
        return nequip_mod.forward_train(cfg, params, batch, G, n_edge_chunks=chunks)

    step = dense = _train_step(loss_fn, opt_cfg)
    if mesh.size > 1 and any(spec_axes(sp) for sp in bspecs.values()):
        def make_step():
            from repro_torch.dist.step import unshard_tree

            return lambda params, opt_state, batch: dense(
                params, opt_state, unshard_tree(batch, bspecs, mesh))

        step = _on_ranks(mesh, make_step)
    return CellSpec(
        arch=arch_id, shape=shape_id, kind="train", step_fn=step,
        abstract_args=(params_abs, opt_abs, batch_abs),
        in_specs=(pspecs, ospecs, bspecs), out_specs=(pspecs, ospecs, P()), meta=meta)


# ===========================================================================
# RecSys cells
# ===========================================================================


def _recsys_flops_fwd(arch_id, cfg, B):
    if arch_id.startswith("fm"):
        return 4.0 * B * cfg.n_sparse * cfg.embed_dim
    if arch_id.startswith("sasrec"):
        S, D = cfg.seq_len, cfg.embed_dim
        per_blk = 8 * S * D * D + 4 * S * S * D
        return B * (cfg.n_blocks * per_blk)
    if arch_id.startswith("autoint"):
        F = cfg.n_sparse
        d = cfg.d_attn
        per_l = 6 * F * cfg.embed_dim * d + 4 * F * F * d
        return B * cfg.n_attn_layers * per_l
    # dlrm
    dims = (cfg.n_dense, *cfg.bot_mlp)
    bot = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    nf = cfg.n_sparse + 1
    inter = 2 * nf * nf * cfg.embed_dim
    d_in = nf * (nf - 1) // 2 + cfg.bot_mlp[-1]
    tdims = (d_in, *cfg.top_mlp)
    top = sum(2 * a * b for a, b in zip(tdims[:-1], tdims[1:]))
    return float(B) * (bot + inter + top)


def _recsys_bytes(arch_id, cfg, B, train: bool):
    lookup = {
        "fm": cfg.n_sparse * (cfg.embed_dim + 1) * 4 if hasattr(cfg, "n_sparse") else 0,
        "sasrec": 3 * getattr(cfg, "seq_len", 0) * getattr(cfg, "embed_dim", 0) * 4,
        "autoint": getattr(cfg, "n_sparse", 0) * getattr(cfg, "embed_dim", 0) * 4,
        "dlrm-mlperf": getattr(cfg, "n_sparse", 0) * getattr(cfg, "embed_dim", 0) * 4,
    }
    key = arch_id.split("-reduced")[0]
    key = key if key in lookup else arch_id
    per_row = lookup.get(key, 64)
    factor = 4 if train else 1   # grads + moments touch the same rows
    return float(B) * per_row * factor


#: each recsys arch's (init, train loss)
RECSYS = {
    "fm": (recsys_mod.fm_init, recsys_mod.fm_train_loss),
    "sasrec": (recsys_mod.sasrec_init, recsys_mod.sasrec_train_loss),
    "autoint": (recsys_mod.autoint_init, recsys_mod.autoint_train_loss),
    "dlrm-mlperf": (recsys_mod.dlrm_init, recsys_mod.dlrm_train_loss),
}


def _recsys_inputs(fam, cfg, B):
    if fam == "sasrec":
        return {
            "item_seq": _meta((B, cfg.seq_len), torch.int32),
            "pos_items": _meta((B, cfg.seq_len), torch.int32),
            "neg_items": _meta((B, cfg.seq_len), torch.int32),
            "label": _meta((B,), torch.float32),
        }
    batch = {"sparse": _meta((B, cfg.n_sparse), torch.int32),
             "label": _meta((B,), torch.float32)}
    if fam == "dlrm-mlperf":
        batch["dense"] = _meta((B, cfg.n_dense), torch.float32)
    return batch


def _recsys_serve_step(fam, cfg):
    if fam == "sasrec":
        return lambda params, batch: recsys_mod.sasrec_serve(cfg, params, batch)
    if fam == "fm":
        return lambda params, batch: recsys_mod.fm_logits(cfg, params, batch["sparse"])
    if fam == "autoint":
        return lambda params, batch: recsys_mod.autoint_logits(cfg, params, batch["sparse"])
    return lambda params, batch: recsys_mod.dlrm_logits(cfg, params, batch["dense"],
                                                        batch["sparse"])


def _recsys_cell(arch_id, mod, shape_id, mesh, reduced):
    info = RECSYS_SHAPES[shape_id]
    axes = axes_for_mesh(mesh)
    cfg = mod.reduced_config() if reduced else mod.config()
    kind = info["kind"]
    B = info["batch"] if not reduced else 8
    fam = arch_id
    init_fn, loss_fn = RECSYS[fam]

    params_abs = init_fn(cfg, None, device="meta")
    if kind != "train" and not reduced:
        # serving copy of the big tables in bf16: halves row-exchange bytes
        params_abs = map_leaves(
            lambda ab: _meta(ab.shape, torch.bfloat16)
            if ab.dim() == 2 and ab.shape[0] >= recsys_mod.LARGE_TABLE_ROWS else ab,
            params_abs)
    pspecs = recsys_param_specs(params_abs, axes, mesh)

    def batch_specs(batch_abs):
        return {k: P(axes.dp) if v.dim() == 1 else P(axes.dp, None) for k, v in batch_abs.items()}

    meta = dict(
        model_flops=_recsys_flops_fwd(fam, cfg, B) * (3 if kind == "train" else 1),
        analytic_flops=_recsys_flops_fwd(fam, cfg, B) * (3 if kind == "train" else 1),
        analytic_bytes=_recsys_bytes(fam, cfg, B, kind == "train"),
        scan_trips=1,
        params_total=_params_total(params_abs),
        params_active=0,
        tokens=B,
    )

    if kind == "train":
        opt_cfg = AdamWConfig()
        ospecs = opt_state_specs(pspecs, params_abs, axes, dp_size(mesh, axes))
        batch_abs = _recsys_inputs(fam, cfg, B)
        if mesh.size > 1:
            def make_step():
                from repro_torch.dist.collectives import pmean
                from repro_torch.dist.step import mean_over_data, zero1_train_step

                def rank_loss(p, batch):
                    return loss_fn(cfg, recsys_mod.row_blocks(p, pspecs, mesh), batch)

                def vg(params, batch):
                    loss, grads = value_and_grad(rank_loss, params, batch)
                    return (pmean(loss, mesh, "data"),
                            mean_over_data(grads, pspecs, ospecs["m"], mesh))

                return zero1_train_step(vg, opt_cfg, mesh, pspecs, ospecs["m"])

            step = _on_ranks(mesh, make_step)
        else:
            step = _train_step(lambda p, batch: loss_fn(cfg, p, batch), opt_cfg)
        return CellSpec(
            arch=arch_id, shape=shape_id, kind=kind, step_fn=step,
            abstract_args=(params_abs, opt_state_shapes(params_abs, opt_cfg), batch_abs),
            in_specs=(pspecs, ospecs, batch_specs(batch_abs)),
            out_specs=(pspecs, ospecs, P()), meta=meta)

    def on_row_blocks(step, spread=False):
        """``step`` on this rank's tables as ``RowBlock``s on several ranks
        (``spread`` for a retrieval's candidates)."""
        if mesh.size == 1:
            return step
        return _on_ranks(mesh, lambda: lambda params, *args: step(
            recsys_mod.row_blocks(params, pspecs, mesh, spread), *args))

    if kind == "serve":
        batch_abs = _recsys_inputs(fam, cfg, B)
        if fam == "sasrec":
            batch_abs = {"item_seq": batch_abs["item_seq"], "target": _meta((B,), torch.int32)}
        else:
            batch_abs.pop("label")
        return CellSpec(arch=arch_id, shape=shape_id, kind=kind,
                        step_fn=on_row_blocks(_recsys_serve_step(fam, cfg)),
                        abstract_args=(params_abs, batch_abs),
                        in_specs=(pspecs, batch_specs(batch_abs)), out_specs=P(axes.dp),
                        meta=meta)

    # retrieval: one query against n_candidates
    ncand = info.get("n_candidates", 1000) if not reduced else 64
    cand_abs = _meta((ncand,), torch.int32)
    cand_spec = P(_maybe_axes(ncand, mesh, axes.all_axes))
    meta = dict(meta)
    meta["model_flops"] = _recsys_flops_fwd(fam, cfg, ncand)
    meta["analytic_flops"] = meta["model_flops"]
    meta["analytic_bytes"] = _recsys_bytes(fam, cfg, ncand, False)
    meta["tokens"] = ncand

    if fam == "sasrec":
        def step(params, item_seq, cand):
            return recsys_mod.sasrec_retrieval(cfg, params, item_seq, cand)

        args = (params_abs, _meta((1, cfg.seq_len), torch.int32), cand_abs)
        ispecs = (pspecs, P(), cand_spec)
    elif fam in ("fm", "autoint"):
        retrieval = recsys_mod.fm_retrieval if fam == "fm" else recsys_mod.autoint_retrieval

        def step(params, user, cand):
            return retrieval(cfg, params, user, cand)

        args = (params_abs, _meta((cfg.n_sparse,), torch.int32), cand_abs)
        ispecs = (pspecs, P(), cand_spec)
    else:
        def step(params, dense, user, cand):
            return recsys_mod.dlrm_retrieval(cfg, params, dense, user, cand)

        args = (params_abs, _meta((cfg.n_dense,), torch.float32),
                _meta((cfg.n_sparse,), torch.int32), cand_abs)
        ispecs = (pspecs, P(), P(), cand_spec)

    return CellSpec(arch=arch_id, shape=shape_id, kind=kind,
                    step_fn=on_row_blocks(step, spread=True),
                    abstract_args=args, in_specs=ispecs, out_specs=cand_spec, meta=meta)


# ===========================================================================
# Entry points
# ===========================================================================


def build_cell(arch_id: str, shape_id: str, reduced: bool = False, mesh=None) -> CellSpec:
    """The cell of ``arch_id`` at ``shape_id`` on ``mesh`` (default
    ``make_host_mesh()``; at the arch's ``reduced_config()`` with
    ``reduced``; LM cells keep the shape's batch and length, GNN cells take
    64 nodes, 128 edges and 4 graphs, recsys cells a batch of 8 and 64
    candidates, as the reference's)."""
    mesh = make_host_mesh() if mesh is None else mesh
    mod = get_arch_module(arch_id)
    if shape_id not in ARCH_SHAPES[arch_id]:
        raise KeyError(f"{arch_id} has no shape {shape_id!r} (have "
                       f"{', '.join(ARCH_SHAPES[arch_id])})")
    if mod.FAMILY == "lm":
        return _lm_cell(arch_id, mod, shape_id, mesh, reduced)
    if mod.FAMILY == "gnn":
        return _gnn_cell(arch_id, mod, shape_id, mesh, reduced)
    return _recsys_cell(arch_id, mod, shape_id, mesh, reduced)


def all_cells():
    """Every (arch, shape) pair of the matrix, in the reference's order."""
    for arch in ALL_ARCHS:
        for shape in ARCH_SHAPES[arch]:
            yield arch, shape
