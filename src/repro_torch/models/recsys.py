"""RecSys architectures: FM, SASRec, AutoInt, DLRM-MLPerf (counterpart of
``repro.models.recsys``).

Shared substrate: one concatenated embedding matrix per model (the tables
are the dominant state: DLRM's MLPerf tables are about 188M rows x 128).
Every row lookup is ``lookup(table, ids)``: on the card the embedding-bag
kernel (``kernels.embedding_bag``, ``csrc/model_kernels.cu``) with bags of
one, on the CPU the plain gather; its gradient is a dense scatter-add into
the table's shape, as ``jax.grad`` of ``jnp.take`` gives (accumulated in
f64, rounded once).

Per arch:
  ``*_train_loss``  logloss (FM/AutoInt/DLRM) or BCE with sampled
                    negatives (SASRec);
  ``*_logits`` / ``sasrec_serve``  score a batch of requests;
  ``*_retrieval``   one query against n candidates: the candidate-varying
                    field is looked up per candidate, everything else once.

The serving copy keeps bf16 tables beside f32 MLPs, norms and biases.  JAX
promotes ``f32[] + bf16[B]`` and ``bf16 @ f32`` to f32; torch gives bf16
for the first and refuses the second, so every place where the reference
relies on promotion casts both operands to their promoted type (``_cast``),
and every output dtype is the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.common import resolve_device
from repro_torch.dist.collectives import gather_, psum, reduce_scatter_
from repro_torch.dist.sharding import spec_dims
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models.common import mlp, normal_init
from repro_torch.train.tree import flatten, unflatten

# MLPerf DLRM (Criteo 1TB) per-table row counts
MLPERF_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

#: tables of at least this many rows are padded to a multiple of 1,024 rows
#: (and served in bf16 by the registry's serving copy)
LARGE_TABLE_ROWS = 1 << 16


# ===========================================================================
# Shared helpers
# ===========================================================================


class _Lookup(torch.autograd.Function):
    """``table[ids]`` through the embedding-bag kernel on the card.  The
    gradient is a dense scatter-add of the output gradient into a zero
    table (``index_add_``), accumulated in f64 and rounded once to the
    table's dtype: a hot row sums up to about 10^6 contributions, in any
    order on the card, and f32 sums of them would drift by about 1e-6 from
    the exact one (plain ``table[ids]`` autograd's sorted f32 sums too).
    ``index_put_(accumulate=True)``, plain autograd's own, sums each row's
    run serially and took about 1 s a SASRec training step on Zipf ids.
    On the card a negative id is the kernel's padding, a zero row, and
    takes no gradient."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        if ids.device.type != "cuda":
            return table[ids.long()]
        bags = ids.reshape(-1, 1).to(torch.int32).contiguous()
        out = embedding_bag(table, bags, mode="sum")
        return out.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        idx = ids.reshape(-1).long()
        grad = grad.reshape(-1, ctx.table_shape[1]).double()
        if ids.device.type == "cuda":
            grad = torch.where((idx >= 0)[:, None], grad, 0.0)
            idx = idx.clamp(min=0)
        g = torch.zeros(ctx.table_shape, dtype=torch.float64, device=grad.device)
        g.index_add_(0, idx, grad)
        return g.to(ctx.table_dtype), None


def lookup(table, ids):
    """Rows of ``table`` [V, D] (f32 or bf16) at integer ``ids`` of any
    shape: ``ids.shape + (D,)`` in the table's dtype, each row bit for bit
    (the reference's ``jnp.take(table, ids, axis=0)``).

    On CUDA tensors this launches the embedding-bag kernel once, with bags
    of one (``ids`` as contiguous int32 [N, 1], ``mode="sum"``: one f32
    accumulate and one rounding give the row back exactly); on CPU tensors
    it is the plain gather ``table[ids]``.  Out-of-range ids differ by
    device (ROADMAP C): on the CPU a negative id counts from the end (as in
    ``jnp.take``) and an id >= V raises ``IndexError``; on the card a
    negative id gives a zero row (the kernel's padding) and ids are not
    checked against V, since a check would wait on the card.  The batch
    pipeline (``recsys_batches``) draws every id in range.

    ``table`` may be a ``RowBlock``, a rank's rows of a table row-sharded
    over its ``model`` group (``RowBlock.lookup``)."""
    if isinstance(table, RowBlock):
        return table.lookup(ids)
    return _Lookup.apply(table, ids)


class RowBlock:
    """A rank's block of a table row-sharded over the ``model`` group of a
    ``launch.mesh.RankMesh`` (``dist.sharding.recsys_param_specs``): rows
    [r n, (r + 1) n) of the table, r the rank's place in the group.

    ``lookup(ids)`` maps the ids outside the block to "no row" (on the
    card -1, which the embedding-bag kernel reads as padding, a zero row:
    the lookup stays one launch; on the CPU an explicit mask, since a
    negative id counts from the end there, ROADMAP C12), then sums over
    ``model``: one row and zeros, so the sharded lookup equals the whole
    one bit for bit.  A row's gradient stays on the rank that owns it;
    masked ids add nothing.  With ``spread`` the ids may differ between the
    group's ranks (a retrieval's candidates, sharded over every axis): the
    group's ids are gathered, looked up, and the rows reduce-scattered back
    to their ranks, with no gradient (ids the same on every rank come back
    as the psum gives them)."""

    def __init__(self, table, mesh, spread: bool = False):
        self.table, self.mesh, self.spread = table, mesh, spread
        self.lo = mesh.group_rank("model") * table.shape[0]

    @property
    def dtype(self):
        return self.table.dtype

    def local_rows(self, ids):
        """This block's rows at ``ids`` (global row numbers), zero rows for
        the ids it does not hold."""
        n = self.table.shape[0]
        local = ids - self.lo
        inside = (local >= 0) & (local < n)
        if ids.device.type == "cuda":
            return _Lookup.apply(self.table, torch.where(inside, local, -1))
        rows = _Lookup.apply(self.table, torch.where(inside, local, 0))
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype))

    def lookup(self, ids):
        if not self.spread:
            return psum(self.local_rows(ids), self.mesh, "model")
        if torch.is_grad_enabled() and self.table.requires_grad:
            raise RuntimeError("a spread lookup has no gradient; run it under no_grad")
        flat = ids.reshape(-1)
        rows = self.local_rows(gather_(flat, self.mesh, "model", 0))
        return reduce_scatter_(rows, self.mesh, "model", 0).reshape(*ids.shape, -1)


def row_blocks(params, specs, mesh, spread: bool = False):
    """``params`` (a rank's blocks by ``specs``) with every table that its
    spec splits over the model axis as a ``RowBlock`` of that ``spread``."""
    return unflatten(params, [
        RowBlock(p, mesh, spread) if spec_dims(s, p.dim(), mesh)[0] == 0 else p
        for p, s in zip(flatten(params)[0], flatten(specs)[0])])


def _cast(*xs):
    """``xs`` in their promoted floating type (f32 where an f32 operand
    meets a bf16 one), as JAX promotes them whatever their ranks."""
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return [x.to(dt) for x in xs]


def _criteo_like_sizes(n_fields: int, target_total: int = 10_000_000):
    """Synthetic per-field vocab sizes with a realistic skew."""
    base = [3, 10, 60, 250, 1000, 5000, 20_000, 100_000, 500_000, 2_000_000]
    sizes = [base[i % len(base)] for i in range(n_fields)]
    scale = target_total / sum(sizes)
    return tuple(max(3, int(s * scale)) for s in sizes)


def _field_offsets(sizes: Sequence[int], device="cuda"):
    """(int32 [F] offset of each field's rows in the concatenated table on
    ``device``, the table's total rows)."""
    off = [0]
    for s in sizes:
        off.append(off[-1] + s)
    return torch.tensor(off[:-1], dtype=torch.int32, device=resolve_device(device)), off[-1]


def _embed_init(generator, rows, dim, dtype, scale=0.01, device="cuda"):
    """N(0, scale^2) [rows, dim].  Large tables pad their row count to a
    multiple of 1,024 so row-wise sharding divides evenly (and shapes match
    the reference's for ``convert``); padding rows are never indexed."""
    if rows >= LARGE_TABLE_ROWS:
        rows = -(-rows // 1024) * 1024
    return normal_init(generator, (rows, dim), dtype, scale, device)


def _logloss(logits, labels):
    """Mean binary cross entropy with logits, in the reference's form."""
    labels = labels.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


# ===========================================================================
# FM: Rendle ICDM'10.  O(nk) sum-square trick.
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_sizes: tuple = ()
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if not self.vocab_sizes:
            object.__setattr__(self, "vocab_sizes", _criteo_like_sizes(self.n_sparse))


def fm_init(cfg: FMConfig, generator: torch.Generator, device="cuda") -> dict:
    dev = resolve_device(device)
    _, total = _field_offsets(cfg.vocab_sizes, dev)
    return {
        "emb": _embed_init(generator, total, cfg.embed_dim, cfg.param_dtype, device=dev),
        "lin": _embed_init(generator, total, 1, cfg.param_dtype, device=dev),
        "bias": torch.zeros((), dtype=cfg.param_dtype, device=dev),
    }


def fm_logits(cfg: FMConfig, params, sparse_ids):
    """sparse_ids int32 [B, F] (per-field local ids) -> [B]."""
    offsets, _ = _field_offsets(cfg.vocab_sizes, sparse_ids.device)
    gids = sparse_ids + offsets[None, :]
    ve = lookup(params["emb"], gids)                      # [B, F, D]
    le = lookup(params["lin"], gids)[..., 0]              # [B, F]
    s = ve.sum(dim=1)                                     # [B, D]
    pair = 0.5 * ((s * s).sum(-1) - (ve * ve).sum((-1, -2)))
    bias, lin, pair = _cast(params["bias"], le.sum(-1), pair)
    return bias + lin + pair


def fm_train_loss(cfg, params, batch):
    return _logloss(fm_logits(cfg, params, batch["sparse"]), batch["label"])


def fm_retrieval(cfg: FMConfig, params, user_sparse, cand_ids, cand_field: int = 0):
    """Score one user (int32 [F]) against candidates (int32 [N]) filling
    field ``cand_field`` -> [N]."""
    dev = user_sparse.device
    offsets, _ = _field_offsets(cfg.vocab_sizes, dev)
    user_fields = torch.tensor([f for f in range(cfg.n_sparse) if f != cand_field],
                               dtype=torch.long, device=dev)
    ug = user_sparse[user_fields] + offsets[user_fields]
    uv = lookup(params["emb"], ug)                        # [F-1, D]
    ul = lookup(params["lin"], ug)[..., 0]
    s_user = uv.sum(0)
    bias, lin, pair = _cast(params["bias"], ul.sum(),
                            0.5 * ((s_user * s_user).sum() - (uv * uv).sum()))
    const = bias + lin + pair
    cg = cand_ids + offsets[cand_field]
    cv = lookup(params["emb"], cg)                        # [N, D]
    cl = lookup(params["lin"], cg)[..., 0]
    const, cl, dot = _cast(const, cl, cv @ s_user)
    return const + cl + dot


# ===========================================================================
# SASRec: self-attentive sequential recommendation (arXiv:1808.09781)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    param_dtype: torch.dtype = torch.float32


def sasrec_init(cfg: SASRecConfig, generator: torch.Generator, device="cuda") -> dict:
    dev = resolve_device(device)
    D, dt = cfg.embed_dim, cfg.param_dtype
    p = {
        "item_emb": _embed_init(generator, cfg.n_items + 1, D, dt, 0.02, dev),
        "pos_emb": _embed_init(generator, cfg.seq_len, D, dt, 0.02, dev),
        "blocks": [],
    }
    for _ in range(cfg.n_blocks):
        w = {name: _embed_init(generator, D, D, dt, D ** -0.5, dev)
             for name in ("wq", "wk", "wv", "w1", "w2")}
        p["blocks"].append({
            "wq": w["wq"], "wk": w["wk"], "wv": w["wv"],
            "w1": w["w1"], "b1": torch.zeros(D, dtype=dt, device=dev),
            "w2": w["w2"], "b2": torch.zeros(D, dtype=dt, device=dev),
            "ln1": torch.ones(D, dtype=dt, device=dev),
            "ln2": torch.ones(D, dtype=dt, device=dev),
        })
    return p


def _ln(x, g):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-6) * g


def sasrec_encode(cfg: SASRecConfig, params, item_seq):
    """item_seq int32 [B, S] (0 = padding) -> hidden states [B, S, D].  A
    query at a padded position has no valid key: every logit is -1e30 and
    its softmax is uniform, as the reference's."""
    B, S = item_seq.shape
    x = lookup(params["item_emb"], item_seq)
    x = x + params["pos_emb"][None, :S]
    mask = (item_seq > 0)[:, None, None, :]               # key mask
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=item_seq.device))[None, None]
    H = cfg.n_heads
    Dh = cfg.embed_dim // H
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1"])
        q = (h @ blk["wq"]).reshape(B, S, H, Dh).transpose(1, 2)
        k = (h @ blk["wk"]).reshape(B, S, H, Dh).transpose(1, 2)
        v = (h @ blk["wv"]).reshape(B, S, H, Dh).transpose(1, 2)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (Dh ** -0.5)
        logits = torch.where(causal & mask, logits, -1e30)
        attn = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2)
        x = x + o.reshape(B, S, cfg.embed_dim)
        h = _ln(x, blk["ln2"])
        x = x + F.relu(h @ blk["w1"] + blk["b1"]) @ blk["w2"] + blk["b2"]
    return x


def sasrec_train_loss(cfg, params, batch):
    """BCE over (positive next item, sampled negative) at each position."""
    seq = batch["item_seq"]                               # [B, S]
    pos = batch["pos_items"]                              # [B, S]
    neg = batch["neg_items"]                              # [B, S]
    h = sasrec_encode(cfg, params, seq)                   # [B, S, D]
    pe = lookup(params["item_emb"], pos)
    ne = lookup(params["item_emb"], neg)
    pos_score = (h * pe).sum(-1)
    neg_score = (h * ne).sum(-1)
    mask = (pos > 0).float()
    loss = -(F.logsigmoid(pos_score) + F.logsigmoid(-neg_score)) * mask
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)


def sasrec_serve(cfg, params, batch):
    """Score (sequence, target) pairs: ``item_seq`` [B, S], ``target`` [B]
    -> [B]."""
    h = sasrec_encode(cfg, params, batch["item_seq"])[:, -1]
    te = lookup(params["item_emb"], batch["target"])
    return (h * te).sum(-1)


def sasrec_retrieval(cfg, params, item_seq, cand_ids):
    """One sequence [1, S] against candidates [N]: final state .
    candidate embeddings -> [N]."""
    h = sasrec_encode(cfg, params, item_seq)[:, -1][0]    # [D]
    ce = lookup(params["item_emb"], cand_ids)             # [N, D]
    ce, h = _cast(ce, h)
    return ce @ h


# ===========================================================================
# AutoInt: attention-based feature interaction (arXiv:1810.11921)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    vocab_sizes: tuple = ()
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if not self.vocab_sizes:
            object.__setattr__(self, "vocab_sizes", _criteo_like_sizes(self.n_sparse))


def autoint_init(cfg: AutoIntConfig, generator: torch.Generator, device="cuda") -> dict:
    dev = resolve_device(device)
    dt = cfg.param_dtype
    _, total = _field_offsets(cfg.vocab_sizes, dev)
    p = {"emb": _embed_init(generator, total, cfg.embed_dim, dt, device=dev), "layers": []}
    d = cfg.embed_dim
    for _ in range(cfg.n_attn_layers):
        p["layers"].append({name: _embed_init(generator, d, cfg.d_attn, dt, d ** -0.5, dev)
                            for name in ("wq", "wk", "wv", "wres")})
        d = cfg.d_attn
    p["out_w"] = _embed_init(generator, cfg.n_sparse * d, 1, dt, device=dev)
    p["out_b"] = torch.zeros((), dtype=dt, device=dev)
    return p


def autoint_logits(cfg: AutoIntConfig, params, sparse_ids):
    """sparse_ids int32 [B, F] -> [B]."""
    offsets, _ = _field_offsets(cfg.vocab_sizes, sparse_ids.device)
    x = lookup(params["emb"], sparse_ids + offsets[None, :])   # [B, F, D]
    return _autoint_attend(cfg, params, x)


def _mm(x, w):
    x, w = _cast(x, w)
    return x @ w


def _autoint_attend(cfg: AutoIntConfig, params, x):
    H = cfg.n_heads
    dh = cfg.d_attn // H
    for lp in params["layers"]:
        lead = x.shape[:-1]
        q = _mm(x, lp["wq"]).reshape(*lead, H, dh)
        k = _mm(x, lp["wk"]).reshape(*lead, H, dh)
        v = _mm(x, lp["wv"]).reshape(*lead, H, dh)
        logits = torch.einsum("bfhd,bghd->bhfg", q, k) * (dh ** -0.5)
        attn = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", attn, v).reshape(*lead, cfg.d_attn)
        x = F.relu(o + _mm(x, lp["wres"]))
    flat = x.reshape(x.shape[0], -1)
    out, b = _cast(_mm(flat, params["out_w"])[..., 0], params["out_b"])
    return out + b


def autoint_train_loss(cfg, params, batch):
    return _logloss(autoint_logits(cfg, params, batch["sparse"]), batch["label"])


def autoint_retrieval(cfg, params, user_sparse, cand_ids, cand_field: int = 0):
    """Bulk-score candidates [N] by swapping one field's id of the user
    [F] -> [N].  The user's rows are looked up once; only the candidate
    field's rows are looked up per candidate."""
    offsets, _ = _field_offsets(cfg.vocab_sizes, user_sparse.device)
    n = cand_ids.shape[0]
    ue = lookup(params["emb"], user_sparse + offsets)                  # [F, D]
    ce = lookup(params["emb"], cand_ids + offsets[cand_field])         # [N, D]
    x = ue[None].expand(n, cfg.n_sparse, cfg.embed_dim)
    x = torch.cat([x[:, :cand_field], ce[:, None], x[:, cand_field + 1:]], dim=1)
    return _autoint_attend(cfg, params, x)


# ===========================================================================
# DLRM: MLPerf config (arXiv:1906.00091)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    bot_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    vocab_sizes: tuple = MLPERF_TABLE_SIZES
    param_dtype: torch.dtype = torch.float32


def dlrm_init(cfg: DLRMConfig, generator: torch.Generator, device="cuda") -> dict:
    dev = resolve_device(device)
    dt = cfg.param_dtype
    _, total = _field_offsets(cfg.vocab_sizes, dev)
    p = {"emb": _embed_init(generator, total, cfg.embed_dim, dt, device=dev)}

    def mlp_params(dims):
        ws = [_embed_init(generator, dims[i], dims[i + 1], dt, dims[i] ** -0.5, dev)
              for i in range(len(dims) - 1)]
        bs = [torch.zeros(dims[i + 1], dtype=dt, device=dev) for i in range(len(dims) - 1)]
        return ws, bs

    p["bot_w"], p["bot_b"] = mlp_params((cfg.n_dense, *cfg.bot_mlp))
    n_feat = cfg.n_sparse + 1
    d_inter = n_feat * (n_feat - 1) // 2 + cfg.bot_mlp[-1]
    p["top_w"], p["top_b"] = mlp_params((d_inter, *cfg.top_mlp))
    return p


def _dot_interaction(z):
    """z [B, F, D] -> upper-triangle pairwise dots [B, F(F-1)/2], row-major
    (``jnp.triu_indices(F, k=1)``'s order)."""
    F_ = z.shape[1]
    zz = torch.bmm(z, z.transpose(1, 2))
    iu, ju = torch.triu_indices(F_, F_, 1, device=z.device)
    return zz[:, iu, ju]


def dlrm_logits(cfg: DLRMConfig, params, dense, sparse_ids):
    """dense f32 [B, 13], sparse_ids int32 [B, 26] -> [B]."""
    offsets, _ = _field_offsets(cfg.vocab_sizes, sparse_ids.device)
    bot = mlp(dense, params["bot_w"], params["bot_b"])            # [B, 128]
    emb = lookup(params["emb"], sparse_ids + offsets[None, :])    # [B, 26, 128]
    bot_row, emb = _cast(bot[:, None, :], emb)
    z = torch.cat([bot_row, emb], dim=1)                          # [B, 27, 128]
    inter = _dot_interaction(z)
    top_in = torch.cat(_cast(bot, inter), dim=-1)
    return mlp(top_in, params["top_w"], params["top_b"])[..., 0]


def dlrm_train_loss(cfg, params, batch):
    return _logloss(dlrm_logits(cfg, params, batch["dense"], batch["sparse"]), batch["label"])


def dlrm_retrieval(cfg, params, dense, user_sparse, cand_ids, cand_field: int = 0,
                   constrain=None):
    """Score one user (dense [13], sparse [26]) against candidates [N]
    varying one sparse field -> [N].

    The user's 25 constant rows are looked up once and only the candidate
    field's [N, D] rows per candidate.  Serving numerics: the interaction
    runs in the table dtype (bf16 in the serving copy) and the top MLP in
    f32, as the reference's.  ``constrain`` is the reference's GSPMD hint
    (a sharding constraint on the candidate rows); a per-rank program has
    no global layout to hint at, so only ``None`` is accepted."""
    if constrain is not None:
        raise NotImplementedError("dlrm_retrieval: a sharding constraint is a GSPMD layout "
                                  "hint, which a per-rank program (ROADMAP A12.2b) does not "
                                  "run; pass constrain=None")
    dev = user_sparse.device
    offsets, _ = _field_offsets(cfg.vocab_sizes, dev)
    n = cand_ids.shape[0]
    tdt = params["emb"].dtype
    bot = mlp(dense[None, :], params["bot_w"], params["bot_b"])[0].to(tdt)
    user_fields = torch.tensor([f for f in range(cfg.n_sparse) if f != cand_field],
                               dtype=torch.long, device=dev)
    ue = lookup(params["emb"], user_sparse[user_fields] + offsets[user_fields])  # [25, D]
    ce = lookup(params["emb"], cand_ids + offsets[cand_field])                   # [N, D]

    # z rows in canonical order: [bot, field_0, ..., field_25]
    before, after = ue[:cand_field], ue[cand_field:]
    head = torch.cat([bot[None], before], dim=0)
    z = torch.cat([head[None].expand(n, *head.shape), ce[:, None, :],
                   after[None].expand(n, *after.shape)], dim=1)     # [N, 27, D]
    inter = _dot_interaction(z).float()
    top_in = torch.cat([bot[None].float().expand(n, cfg.bot_mlp[-1]), inter], dim=-1)
    return mlp(top_in, params["top_w"], params["top_b"])[..., 0]
