"""Llama-family decoder transformers (counterpart of
``repro.models.transformer``): the training step ``forward_train`` and the
serving steps ``forward_prefill`` and ``forward_decode`` of dense LMs
(Llama 3.x, Mistral, SmolLM) and of MoE LMs with top-1 routing, a shared
expert and a 3:1 chunked-local:global attention interleave (Llama 4 Scout
and Maverick).

Parameters are a plain dict with the reference's keys and layouts:
``embed`` [V, D], ``final_norm`` [D], ``lm_head`` [D, V] (absent when tied)
and, per sub-layer position ``p`` of a group, ``blocks/pos{p}`` holding
tensors stacked over the ``n_groups`` groups: ``attn_norm``/``ffn_norm``
[G, D], ``wq`` [G, D, H, Dh], ``wk``/``wv`` [G, D, K, Dh], ``wo``
[G, H, Dh, D], ``w_gate``/``w_up`` [G, D, F], ``w_down`` [G, F, D]; an MoE
layer has instead ``router`` [G, D, E], ``we_gate``/``we_up`` [G, E, D, F_e],
``we_down`` [G, E, F_e, D] and, with a shared expert, ``ws_gate``/``ws_up``
[G, D, F], ``ws_down`` [G, F, D] (F_e is ``d_ff_expert or d_ff``).  The KV
cache is ``{pos{p}: {"k", "v"}}`` of [G, B, S_max, K, Dh].  Groups run as a
Python loop (the reference's ``lax.scan``); in ``forward_train`` each group
is one non-reentrant ``torch.utils.checkpoint`` (the reference's
``nothing_saveable`` remat): only the group's input is kept, and the
backward reruns the group's forward, its attention kernel included.

Attention: GQA with RoPE on every layer of a dense (period-1) model and on
the local layers of a Llama 4 group (its global layers are NoPE: iRoPE).  A
local layer attends causally within chunks of ``local_chunk`` positions
(``_chunked_local_attention``: one attention call over the [B * n_chunks,
C] view).  ``attention_impl="flash"`` runs training and prefill attention
through the hand-written kernel (``repro_torch.kernels.flash_attention``,
differentiable by the reference's recompute VJP); ``"xla"`` is the
reference's blockwise path in plain tensor code, differentiated by
autograd.  Decode attention is plain tensor code on both, as in the
reference, a local layer masking the keys before its chunk's start.

MoE (``_moe_ffn``): the reference's local, one-device dispatch in plain
tensor code (the reference has no kernel for it): top-1 routing, tokens
stably sorted by expert, each expert's first ``capacity`` tokens in an
[E, capacity, D] buffer, batched expert products, the gated combine, the
shared expert and the Switch auxiliary loss; a one-token-per-sequence call
(decode) computes every expert and drops nothing.

Expert parallelism (``_moe_ffn_ep``, chosen where ``cfg.ep_mesh`` is set):
a per-rank program over ``torch.distributed``, the reference's
``shard_map`` body run on each rank of a ``launch.mesh.RankMesh``.  The
rank holds its data shard of the tokens (replicated over ``model``) and
its ``E / ep`` experts of each layer (with ``ep_fsdp`` also cut over the
data axes on F, gathered before use).  It routes its tokens locally, the
capacity from its own token count; exchanges the [E, cap, D] buffer over
the ``model`` group ([E, cap, D] -> [E/ep, ep * cap, D]); runs its experts
in checkpointed chunks of about 2,048 slots; exchanges back, combines, and
returns the Switch auxiliary loss averaged over every rank.  The
exchanges are differentiable (``dist.collectives``), so one backward on
every rank gives each its gradients; ``dist.step`` reduces them to the
gradient of the reference's loss, the mean over data shards of each
shard's loss (its auxiliary loss the shard's own routing's).  The
reference's other uses of its mesh are GSPMD layout hints that leave
values unchanged: ``_seq_shard_constraint`` (the residual stream
sequence-sharded over ``model``) and the context-parallel constraints on
k, v and q in ``_gqa_attention``.  A per-rank program has no global
layout to hint at, so they have no counterpart here.

Placement (``layout=``, a ``dist.tp.Layout``).  The three entry points
take where the parameters lie: by default one rank holding every leaf
whole, where every hook of the layout is the identity.  On a rank mesh
the same code runs the registry's placement: tensor parallelism over
``model`` (the layout's *f* before a split product, its sum after), FSDP
leaves gathered over ``data`` a group at a time inside the checkpoint,
the experts over ``model`` through ``_moe_ffn_ep``, a vocab-parallel
cross entropy, and the rank's cache block and vocab block of the logits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common import resolve_device
from repro_torch.dist.collectives import all_gather, all_reduce_mean, all_to_all
from repro_torch.dist.tp import Layout
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rope, rms_norm, swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 1
    shared_expert: bool = True
    d_ff_expert: Optional[int] = None  # defaults to d_ff
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    moe: Optional[MoEConfig] = None
    period: int = 1
    local_positions: tuple = ()
    local_chunk: int = 8192
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    param_dtype: torch.dtype = torch.bfloat16
    act_dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "xla"          # "xla" | "flash"
    ep_mesh: Any = None
    ep_dp_axes: tuple = ()
    ep_fsdp: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.n_layers} layers do not split into groups of {self.period}")
        return self.n_layers // self.period

    def param_count(self) -> int:
        return self._count(self.moe.n_experts if self.moe else 0)

    def active_param_count(self) -> int:
        """Parameters one token runs through (``top_k`` routed experts, the
        shared expert and the router), the 6*N_active*D convention."""
        return self._count(self.moe.top_k if self.moe else 0)

    def _count(self, routed: int) -> int:
        """Parameters with ``routed`` experts of each MoE layer counted."""
        dh = self.head_dim
        attn = self.d_model * dh * (self.n_heads + 2 * self.n_kv_heads) + (
            self.n_heads * dh * self.d_model
        )
        if self.moe:
            dff = self.moe.d_ff_expert or self.d_ff
            ffn = 3 * self.d_model * dff * routed
            if self.moe.shared_expert:
                ffn += 3 * self.d_model * self.d_ff
            ffn += self.d_model * self.moe.n_experts  # router
        else:
            ffn = 3 * self.d_model * self.d_ff
        per_layer = attn + ffn + 2 * self.d_model
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + self.d_model


def _require_ported(cfg: LMConfig) -> None:
    if cfg.attention_impl not in ("xla", "flash"):
        raise ValueError(f"attention_impl must be 'xla' or 'flash', got {cfg.attention_impl!r}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: LMConfig) -> dict:
    """The parameter tree's shapes, keyed as the reference's ``init_params``."""
    _require_ported(cfg)
    d, dh, G = cfg.d_model, cfg.head_dim, cfg.n_groups
    block = {
        "attn_norm": (G, d),
        "wq": (G, d, cfg.n_heads, dh),
        "wk": (G, d, cfg.n_kv_heads, dh),
        "wv": (G, d, cfg.n_kv_heads, dh),
        "wo": (G, cfg.n_heads, dh, d),
        "ffn_norm": (G, d),
    }
    if cfg.moe:
        E, dff = cfg.moe.n_experts, cfg.moe.d_ff_expert or cfg.d_ff
        block.update(router=(G, d, E), we_gate=(G, E, d, dff), we_up=(G, E, d, dff),
                     we_down=(G, E, dff, d))
        if cfg.moe.shared_expert:
            block.update(ws_gate=(G, d, cfg.d_ff), ws_up=(G, d, cfg.d_ff),
                         ws_down=(G, cfg.d_ff, d))
    else:
        block.update(w_gate=(G, d, cfg.d_ff), w_up=(G, d, cfg.d_ff), w_down=(G, cfg.d_ff, d))
    shapes = {
        "embed": (cfg.vocab, d),
        "final_norm": (d,),
        "blocks": {f"pos{p}": dict(block) for p in range(cfg.period)},
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    return shapes


def init_params(cfg: LMConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters at ``cfg``'s widths in ``cfg.param_dtype``: norms
    are ones, every other tensor N(0, 0.02^2) drawn from ``generator``
    (a generator of ``device``; any generator for ``"meta"``).  The
    reference's layout; its random numbers differ (``jax.random``)."""
    dev = resolve_device(device)

    def make(name, shape):
        if isinstance(shape, dict):
            return {k: make(k, s) for k, s in shape.items()}
        t = torch.empty(shape, dtype=cfg.param_dtype, device=dev)
        if name.endswith("norm"):
            return t.fill_(1.0)
        return t.normal_(0.0, 0.02, generator=generator)

    return {k: make(k, s) for k, s in param_shapes(cfg).items()}


def _head(cfg: LMConfig, params):
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return head.to(cfg.act_dtype)


def _group_params(block, g: int) -> dict:
    return {name: w[g] for name, w in block.items()}


def _group_block(params, g: int) -> dict:
    """Group ``g``'s leaves of every sub-layer position."""
    return {key: _group_params(b, g) for key, b in params["blocks"].items()}


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _gqa_attention(cfg: LMConfig, q, k, v, q_block: int = 512):
    """Causal attention, q [B, S, H, Dh], k/v [B, S, K, Dh] -> [B, S, H, Dh]
    (the reference's ``causal_offset=0``, the only offset its callers pass).

    ``"flash"``: the kernel, on [B, H, S, Dh] views of the same memory (no
    copy, no repeat of the KV heads).  ``"xla"``: blockwise over query
    chunks of ``q_block``; each chunk's logits are formed in the activation
    dtype, scaled in f32, masked with -1e30, softmaxed in f32 and cast back
    to the activation dtype before the PV product, as the reference's
    ``chunk_attn``."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    rep = H // K
    if cfg.attention_impl == "flash":
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=True)
        return out.transpose(1, 2)

    S_kv = k.shape[1]
    qb = min(q_block, S)
    if S % qb:
        raise ValueError(f"sequence {S} is not a multiple of the query block {qb}")
    kpos = torch.arange(S_kv, device=q.device)[None, :]
    qg = q.reshape(B, S, K, rep, Dh)
    out = torch.empty_like(q)
    for s0 in range(0, S, qb):
        qc = qg[:, s0:s0 + qb]
        logits = torch.einsum("bqkrd,btkd->bkrqt", qc, k).float() * (Dh ** -0.5)
        qpos = s0 + torch.arange(qb, device=q.device)[:, None]
        logits = torch.where(kpos <= qpos, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out[:, s0:s0 + qb] = torch.einsum("bkrqt,btkd->bqkrd", probs, v).reshape(B, qb, H, Dh)
    return out


def _chunked_local_attention(cfg: LMConfig, q, k, v):
    """Causal attention within chunks of ``C = min(local_chunk, S)``
    positions (Llama 4's local layers): q [B, S, H, Dh] and k/v [B, S, K,
    Dh] viewed as [B * S/C, C, ...] (no copy) and taken by one
    ``_gqa_attention`` call, so that on ``"flash"`` every chunk of every
    sequence is one launch.  ``S`` must be a multiple of ``C`` (the
    reference asserts it)."""
    B, S, H, Dh = q.shape
    C = min(cfg.local_chunk, S)
    if S % C:
        raise ValueError(f"{cfg.name}: sequence {S} is not a multiple of the local chunk {C}")
    nc, K = S // C, k.shape[2]
    out = _gqa_attention(cfg, q.reshape(B * nc, C, H, Dh), k.reshape(B * nc, C, K, Dh),
                         v.reshape(B * nc, C, K, Dh))
    return out.reshape(B, S, H, Dh)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _project(x, w):
    """x [..., D] @ w [D, *rest] -> [..., *rest]."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _attn_out(attn, wo):
    """attn [..., H, Dh] contracted with wo [H, Dh, D] -> [..., D]."""
    H, Dh, D = wo.shape
    return attn.reshape(*attn.shape[:-2], H * Dh) @ wo.reshape(H * Dh, D)


def _qkv(cfg: LMConfig, pos: int, p, x, positions, lay: Layout | None = None):
    """A layer's normed q [B, S, H, Dh] and k, v [B, S, K, Dh], RoPE
    applied on dense (period-1) models and on local layers (a Llama 4
    global layer is NoPE).  On a ``lay`` that splits the heads: the rank's
    query heads, and its KV heads where ``wk`` splits too, else every KV
    head (the cache's layout)."""
    lay = lay or Layout(cfg)
    h = rms_norm(x, p["attn_norm"])
    hq = lay.col(pos, "wq", h)
    hk = hq if lay.split(pos, "wk") else h
    q, k, v = _project(hq, p["wq"]), _project(hk, p["wk"]), _project(hk, p["wv"])
    if pos in cfg.local_positions or cfg.period == 1:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, lay.kv_grad(pos, k), lay.kv_grad(pos, v)


def moe_capacity(cfg: LMConfig, T: int, capacity_factor: float | None = None) -> int:
    """Tokens an expert takes out of ``T``: ``max(1, min(T, int(T / E *
    capacity_factor)))`` in Python float arithmetic (the reference's)."""
    cf = cfg.moe.capacity_factor if capacity_factor is None else capacity_factor
    return max(1, min(T, int(T / cfg.moe.n_experts * cf)))


class Route(NamedTuple):
    """One MoE layer's routing of T tokens.  ``gate`` [T, E] f32, ``top``
    [T] the chosen expert, ``top_w`` [T] its gate.  With a capacity:
    ``perm`` [T] the tokens stably sorted by expert, and per sorted token
    ``keep`` (within its expert's capacity) and ``dest`` (its row of the
    [E * cap] buffer; ``E * cap``, a spare row, when dropped); ``None``
    without one."""
    gate: torch.Tensor
    top: torch.Tensor
    top_w: torch.Tensor
    perm: Optional[torch.Tensor]
    keep: Optional[torch.Tensor]
    dest: Optional[torch.Tensor]

    def kept(self) -> torch.Tensor:
        """[T] bool in token order: the token reaches its expert."""
        if self.keep is None:
            return torch.ones_like(self.top, dtype=torch.bool)
        return torch.empty_like(self.keep).index_put_((self.perm,), self.keep)


def _route(cfg: LMConfig, router, xf, cap: int | None) -> Route:
    """Top-1 routing of tokens xf [T, D] (lines 310-338 of
    ``repro.models.transformer``).  The scores are formed in xf's dtype and
    only then cast to f32; ``top`` is the gate's first maximum, whatever
    ``top_k`` says.  With ``cap``, the slots: a stable sort by expert, each
    expert's start by ``searchsorted``, a token's slot its sorted position
    less its expert's start."""
    E = cfg.moe.n_experts
    gate = torch.softmax((xf @ router).float(), dim=-1)
    top = torch.argmax(gate, dim=-1)
    top_w = gate.gather(-1, top[:, None])[:, 0]
    if cap is None:
        return Route(gate, top, top_w, None, None, None)
    perm = torch.argsort(top, stable=True)
    top_sorted = top[perm]
    start = torch.searchsorted(top_sorted, torch.arange(E, device=xf.device))
    slot = torch.arange(top.shape[0], device=xf.device) - start[top_sorted]
    keep = slot < cap
    dest = torch.where(keep, top_sorted * cap + slot, E * cap)
    return Route(gate, top, top_w, perm, keep, dest)


def _moe_ffn(cfg: LMConfig, p, x, capacity_factor: float | None = None):
    """Top-1 routed expert plus the shared expert on x [B, S, D], and the
    Switch auxiliary loss ``E * sum_e f_e * P_e`` (f_e the share of tokens
    routed to e, P_e the mean gate; 0.0 on the decode branch).  The
    reference's ``_moe_ffn`` (``repro.models.transformer``, line 292) in
    plain tensor code.

    ``S == 1`` (decode, or a one-token prefill): every expert for the T live
    tokens, the chosen one selected, nothing dropped.  Otherwise the
    capacity dispatch: the sorted tokens scattered into an [E * cap + 1, D]
    buffer (the last row takes the dropped ones: no boolean mask, no host
    sync), the experts as batched products over [E, cap, D], each kept
    token's row gathered back (dropped: 0) and put in token order.  Both
    scale by the gate in the activation dtype."""
    B, S, D = x.shape
    E, T = cfg.moe.n_experts, B * S
    xf = x.reshape(T, D)
    if S == 1:
        r = _route(cfg, p["router"], xf, None)
        y = _every_expert(p, xf)[r.top, torch.arange(T, device=x.device)]
        aux = 0.0
    else:
        cap = moe_capacity(cfg, T, capacity_factor)
        r = _route(cfg, p["router"], xf, cap)
        xe = xf.new_zeros(E * cap + 1, D).index_put((r.dest,), xf[r.perm])
        xe = xe[:E * cap].view(E, cap, D)
        g = F.silu(torch.bmm(xe, p["we_gate"]))
        ye = torch.bmm(g * torch.bmm(xe, p["we_up"]), p["we_down"]).view(E * cap, D)
        rows = ye[torch.where(r.keep, r.dest, 0)]
        y = xf.new_zeros(T, D).index_put((r.perm,), torch.where(r.keep[:, None], rows, 0))
        fe = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
            0, r.top, torch.ones(T, dtype=torch.float32, device=x.device)) / T
        aux = E * torch.sum(fe * r.gate.mean(dim=0))
    y = (y * r.top_w[:, None].to(x.dtype)).reshape(B, S, D)
    if cfg.moe.shared_expert:
        y = y + swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"])
    return y, aux


def _every_expert(p, xf):
    """Every expert of ``p`` (all or the rank's) on every token xf [T, D]:
    [E, T, D]."""
    g = F.silu(torch.matmul(xf, p["we_gate"]))                        # [E, T, F]
    return torch.matmul(g * torch.matmul(xf, p["we_up"]), p["we_down"])


def _moe_decode(cfg: LMConfig, lay: Layout, pos: int, p, h):
    """The MoE FFN of one new token a sequence, h [T, D] (``_moe_ffn``'s
    ``S == 1`` branch): every expert the rank holds, each token's chosen
    one's row (``Layout.expert_rows``) scaled by its gate, plus the shared
    expert."""
    r = _route(cfg, p["router"], h, None)
    y = lay.expert_rows(pos, _every_expert(p, h), r.top) * r.top_w[:, None].to(h.dtype)
    if cfg.moe.shared_expert:
        y = y + lay.mlp(pos, p, h, "ws_gate", "ws_up", "ws_down")
    return y


#: expert slots of one checkpointed chunk of ``_moe_ffn_ep``'s expert FFN
EP_CHUNK = 2048


def _expert_ffn(xc, wg, wu, wd):
    """SwiGLU experts: xc [e, c, D] through wg/wu [e, D, F], wd [e, F, D]."""
    return torch.bmm(F.silu(torch.bmm(xc, wg)) * torch.bmm(xc, wu), wd)


def _moe_ffn_ep(cfg: LMConfig, p, x, capacity_factor: float | None = None):
    """Expert-parallel MoE on this rank (the reference's ``_moe_ffn_ep``,
    line 364): x [B_loc, S, D] is the rank's data shard, ``p``'s expert
    weights its ``E / ep`` experts (F cut over the data axes with
    ``ep_fsdp``), the router and the shared expert whole.  Returns (y
    [B_loc, S, D], the auxiliary loss averaged over every rank)."""
    mesh = cfg.ep_mesh
    E = cfg.moe.n_experts
    ep = mesh.group_size("model")
    if E % ep:
        raise ValueError(f"{cfg.name}: {E} experts do not split over {ep} model ranks")
    Bl, S, D = x.shape
    T = Bl * S
    cap = moe_capacity(cfg, T, capacity_factor or cfg.moe.capacity_factor)
    wg, wu, wd = p["we_gate"], p["we_up"], p["we_down"]
    if cfg.ep_fsdp and mesh.group_size("data") > 1:
        wg, wu = all_gather(wg, mesh, "data", 2), all_gather(wu, mesh, "data", 2)
        wd = all_gather(wd, mesh, "data", 1)

    xf = x.reshape(T, D)
    r = _route(cfg, p["router"], xf, cap)
    xe = xf.new_zeros(E * cap + 1, D).index_put((r.dest,), xf[r.perm])[:E * cap]
    # [E, cap, D] -> [ep (source), E/ep, cap, D] -> [E/ep, ep * cap, D]
    xr = all_to_all(xe.view(E, cap, D), mesh, "model")
    xr = xr.view(ep, E // ep, cap, D).transpose(0, 1).reshape(E // ep, ep * cap, D)
    cp = ep * cap
    nch = max(1, cp // EP_CHUNK)
    while cp % nch:
        nch -= 1
    cc = cp // nch
    ye = torch.cat([checkpoint(_expert_ffn, xr[:, lo:lo + cc], wg, wu, wd, use_reentrant=False)
                    for lo in range(0, cp, cc)], dim=1)
    ye = ye.view(E // ep, ep, cap, D).transpose(0, 1)
    ye = all_to_all(ye, mesh, "model").view(E * cap, D)

    rows = ye[torch.where(r.keep, r.dest, 0)]
    y = xf.new_zeros(T, D).index_put((r.perm,), torch.where(r.keep[:, None], rows, 0))
    y = (y * r.top_w[:, None].to(x.dtype)).reshape(Bl, S, D)
    fe = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, r.top, torch.ones(T, dtype=torch.float32, device=x.device)) / T
    aux = all_reduce_mean(E * torch.sum(fe * r.gate.mean(dim=0)), mesh, "all")
    if cfg.moe.shared_expert:
        y = y + swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"])
    return y, aux


def _ffn(cfg: LMConfig, lay: Layout, pos: int, p, h):
    """The FFN over the full sequence and its auxiliary loss (a dense
    FFN's: 0.0, the reference's ``jnp.float32(0)``).  MoE models route
    expert-parallel over ``lay``'s mesh, or over ``cfg.ep_mesh`` where it
    is set on one whole layout; locally otherwise."""
    if not cfg.moe:
        return lay.mlp(pos, p, h, "w_gate", "w_up", "w_down"), 0.0
    if lay.mesh is None:
        return (_moe_ffn_ep if cfg.ep_mesh is not None else _moe_ffn)(cfg, p, h)
    y, aux = _moe_ffn_ep(lay.ep_cfg, p, h)
    if cfg.moe.shared_expert:
        y = y + lay.mlp(pos, p, h, "ws_gate", "ws_up", "ws_down")
    return y, aux


def _sublayer_train(cfg: LMConfig, pos: int, p, x, positions, lay: Layout):
    """One decoder layer over the full sequence (training, prefill): the
    new residual stream, the FFN's auxiliary loss and the layer's (k, v)
    in the cache's layout.  Local layers attend within their chunks."""
    q, k, v = _qkv(cfg, pos, p, x, positions, lay)
    attend = _chunked_local_attention if pos in cfg.local_positions else _gqa_attention
    attn = attend(cfg, q, lay.kv_heads(pos, k), lay.kv_heads(pos, v))
    x = x + lay.row(pos, "wo", _attn_out(attn, p["wo"]))
    y, aux = _ffn(cfg, lay, pos, p, rms_norm(x, p["ffn_norm"]))
    return x + y, aux, (k, v)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _remat_group(cfg: LMConfig, block, x, aux, lay: Layout | None = None):
    """One group's sub-layers (the reference's ``_remat_group`` body), its
    FSDP leaves gathered first: the new residual stream and the auxiliary
    loss summed on."""
    lay = lay or Layout(cfg)
    block = lay.gather_group(block)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for pos in range(cfg.period):
        x, a, _ = _sublayer_train(cfg, pos, block[f"pos{pos}"], x, positions, lay)
        aux = aux + a
    return x, aux


def forward_train(cfg: LMConfig, params, tokens, labels, layout: Layout | None = None):
    """Mean next-token loss over [B, S] tokens: position s predicts
    ``labels[:, s + 1]``.  Each group runs under a non-reentrant
    ``checkpoint`` (only its input is saved; the backward recomputes it),
    then the final norm and ``_chunked_xent`` over the head (the tied head
    is ``embed.T``; ``Layout.vocab_xent`` where the head is vocab-sharded).
    Plus the reference's ``0.01 * aux / n_groups`` (0 for a dense FFN).

    ``layout`` (``dist.tp.Layout``): where ``params`` lie; by default one
    rank holding them whole.  On a rank mesh, ``params`` are the rank's
    blocks, ``tokens`` and ``labels`` its rows, and the loss is its data
    shard's, the same on every model rank."""
    _require_ported(cfg)
    lay = layout or Layout(cfg)
    top = lay.gather_top(params)
    x = lay.embed(top["embed"], tokens)
    aux = 0.0
    for g in range(cfg.n_groups):
        x, aux = checkpoint(_remat_group, cfg, _group_block(params, g), x, aux, lay,
                            use_reentrant=False)
    x = rms_norm(x, top["final_norm"])
    xent = lay.vocab_xent if lay.vocab_sharded() else functools.partial(_chunked_xent, cfg)
    loss = xent(x[:, :-1], _head(cfg, top), labels[:, 1:])
    return loss + 0.01 * aux / cfg.n_groups


def _chunked_xent(cfg: LMConfig, x, head, labels, chunk: int = 512):
    """Mean cross entropy of x [B, S, D] @ head [D, V] against labels
    [B, S] without the [B, S, V] logits: the reference's unrolled loop over
    sequence chunks of ``chunk`` (the last one ragged), each one [B, chunk,
    V] tile formed in the activation dtype and reduced in f32."""
    B, S, _ = x.shape
    head = head.to(cfg.act_dtype)
    cb = min(chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = 0
    for lo in range(0, S, cb):
        width = min(cb, S - lo)
        logits = (x[:, lo:lo + width] @ head).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, lo:lo + width, None].long())[..., 0]
        total = total + torch.sum(logz - gold)
        count += B * width
    return total / count


# ---------------------------------------------------------------------------
# Prefill / decode with KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_seq: int, device="cuda",
               layout: Layout | None = None) -> dict:
    """A zero KV cache in ``cfg.act_dtype``: ``{pos{p}: {"k", "v"}}`` of
    [G, batch, max_seq, K, Dh] (K the KV heads ``layout``'s rank holds)."""
    dev = resolve_device(device)
    _require_ported(cfg)
    lay = layout or Layout(cfg)
    cache = {}
    for p in range(cfg.period):
        shape = (cfg.n_groups, batch, max_seq, lay.n_kv_heads(p), cfg.head_dim)
        cache[f"pos{p}"] = {n: torch.zeros(shape, dtype=cfg.act_dtype, device=dev)
                            for n in ("k", "v")}
    return cache


def forward_prefill(cfg: LMConfig, params, tokens, max_seq: int | None = None,
                    layout: Layout | None = None):
    """Full-sequence forward of tokens [B, S]: (last-token logits [B, V],
    KV cache).  The cache holds ``max_seq`` positions (default S); positions
    S.. are zero, ready for ``forward_decode``.  On a rank mesh's
    ``layout``: the rank's rows, its vocab block of the logits [B, V/tp]
    and its cache block."""
    _require_ported(cfg)
    lay = layout or Layout(cfg)
    lay.require_vocab_split()
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq or S, device=tokens.device, layout=lay)
    top = lay.gather_top(params)
    x = lay.embed(top["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :]
    for g in range(cfg.n_groups):
        block = lay.gather_group(_group_block(params, g))
        for pos in range(cfg.period):
            key = f"pos{pos}"
            x, _, (k, v) = _sublayer_train(cfg, pos, block[key], x, positions, lay)
            cache[key]["k"][g, :, :S] = k
            cache[key]["v"][g, :, :S] = v
    x = rms_norm(x, top["final_norm"])
    return x[:, -1] @ _head(cfg, top), cache


def _sublayer_decode(cfg: LMConfig, pos: int, p, x, cache_kv, t: int, lay: Layout):
    """One layer, one new token.  x [B, D]; cache k/v [B, S_max, K, Dh]
    (the rank's block), written in place at position t."""
    B, dh = x.shape[0], cfg.head_dim
    q, k, v = _qkv(cfg, pos, p, x[:, None], torch.full((1, 1), t, device=x.device), lay)
    ck, cv = cache_kv["k"], cache_kv["v"]
    ck[:, t] = k[:, 0].to(ck.dtype)
    cv[:, t] = v[:, 0].to(cv.dtype)

    kk, vv = lay.kv_heads(pos, ck), lay.kv_heads(pos, cv)
    H, K = q.shape[2], kk.shape[2]
    qg = q.reshape(B, K, H // K, dh)
    logits = torch.einsum("bkrd,btkd->bkrt", qg, kk).float() * (dh ** -0.5)
    kpos = torch.arange(ck.shape[1], device=x.device)
    valid = kpos <= t
    if pos in cfg.local_positions:  # only the current chunk's keys
        valid = valid & (kpos >= t // cfg.local_chunk * cfg.local_chunk)
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    attn = torch.einsum("bkrt,btkd->bkrd", probs, vv).reshape(B, H, dh)
    x = x + lay.row(pos, "wo", _attn_out(attn, p["wo"]))
    h = rms_norm(x, p["ffn_norm"])
    if cfg.moe:
        return x + _moe_decode(cfg, lay, pos, p, h)
    return x + lay.mlp(pos, p, h, "w_gate", "w_up", "w_down")


def forward_decode(cfg: LMConfig, params, token, cache, t: int, layout: Layout | None = None):
    """One decode step: token [B] at position ``t``.  Returns (logits
    [B, V], cache).  The cache is updated in place (position t of every
    layer) and returned as the same object.  On a rank mesh's ``layout``:
    the rank's rows, its cache block and its vocab block of the logits.

    ``t`` must lie in [0, S_max), S_max being the cache's position
    dimension; otherwise ``ValueError`` is raised before any write.  The
    reference's ``dynamic_update_slice`` writes such a t into the last slot
    instead (clamped past the end, wrapped below 0), silently overwriting
    a prompt token's k/v (ROADMAP C11)."""
    _require_ported(cfg)
    s_max = cache["pos0"]["k"].shape[2]
    if not 0 <= t < s_max:
        raise ValueError(f"{cfg.name}: decode position t={t} is outside the cache of "
                         f"{s_max} positions")
    lay = layout or Layout(cfg)
    lay.require_vocab_split()
    top = lay.gather_top(params)
    x = lay.embed(top["embed"], token)
    for g in range(cfg.n_groups):
        block = lay.gather_group(_group_block(params, g))
        for pos in range(cfg.period):
            key = f"pos{pos}"
            kv = {name: c[g] for name, c in cache[key].items()}
            x = _sublayer_decode(cfg, pos, block[key], x, kv, t, lay)
    x = rms_norm(x, top["final_norm"])
    return x @ _head(cfg, top), cache
