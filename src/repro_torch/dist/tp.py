"""Where a rank's LM parameters lie, and the collectives that follow from
it: the ``Layout`` that ``models.transformer``'s one forward
(``forward_train``, ``forward_prefill``, ``forward_decode``) threads
through every layer.  ``Layout(cfg)`` is one rank holding every leaf whole:
every hook is the identity and the forward is the one-device program.
``Layout(cfg, mesh, pspecs, like)`` reads the registry's placement on a
``launch.mesh.RankMesh``: tensor parallelism over its ``model`` group,
FSDP over its ``data`` group (the counterpart of what GSPMD runs for the
reference's ``jax.jit`` with ``lm_param_specs``, ``zero_spec_for`` and
``lm_cache_specs`` as its ``in_specs``).  The training step over such a
layout, with ZeRO-1 over ``data``, is ``dist.step.tp_train_step``.

A rank holds exactly ``local_shard(leaf, spec)`` of every parameter and
cache leaf.  Every decision below is read from a leaf's spec, never from
the config:

* **Embedding.** ``embed`` sharded over vocab rows: a rank looks up the
  ids of its rows, the rest masked to zero, then ``psum`` over ``model``
  (one row and zeros: the sum is exact).
* **Column-parallel products** (``wq``, ``wk``, ``wv``, ``w_gate``,
  ``w_up``, ``ws_gate``, ``ws_up`` sharded on their output dimension)
  take their input through ``col`` (``sum_grad``, Megatron's *f*: the
  identity, whose backward sums the cotangent over ``model``);
  **row-parallel products** (``wo``, ``w_down``, ``ws_down``) are followed
  by ``row`` (``psum``, *g*).  A product whose leaves the spec leaves
  whole (smollm-135m's 9 heads on a model axis of 2) runs whole on every
  model rank, with neither.
* **GQA with ``wq`` sharded and ``wk``/``wv`` whole** (4 heads and 2 KV
  heads on a model axis of 4): k and v are computed whole, passed through
  ``sum_grad`` (each rank uses only its heads' part of them), and the
  rank's query heads [r H/tp, (r+1) H/tp) take the KV heads h // (H/K)
  of exactly those heads (``kv_heads``): a slice where they are contiguous
  groups, else one KV head a query head.
* **Experts** go through ``models.transformer._moe_ffn_ep`` unchanged over
  this mesh (``ep_cfg``; the expert leaves' specs put the expert axis over
  ``model``, as ``dist.step.ep_param_specs`` does), with the shared expert
  tensor-parallel around the exchange.  A decode step's MoE layer runs the
  rank's experts for every live token and sums the chosen one's row over
  ``model`` (``expert_rows``).
* **The head.** A vocab-sharded head (``lm_head`` [d, V/tp] or the tied
  ``embed.T``) takes a vocab-parallel cross entropy in the reference's
  chunks of 512 positions (``vocab_xent``): per chunk, in f32, the row max
  by ``pmax`` (no gradient), the sum of exponentials by ``psum`` and the
  label's logit from the rank that owns it by a masked ``psum``.  Prefill
  and decode return the rank's vocab block of the logits (the registry's
  ``logits_spec``, ``P(data, model)``).
* **FSDP.** A leaf whose spec carries the data axes is all-gathered over
  ``data`` one group at a time inside the checkpointed group
  (``gather_group``: the recompute gathers again, so full weights live one
  group at a time); the gather's backward, a reduce-scatter, is that
  leaf's gradient reduction.  ``embed``, ``lm_head`` and ``final_norm``
  are gathered once a step (``gather_top``).
* **Caches** hold the rank's batch rows and its KV heads where ``wk``'s
  spec splits them, else every KV head (``n_kv_heads``).

The reference's layout hints are not run: the sequence-parallel residual
(``_seq_shard_constraint``) and the context-parallel constraints in
``_gqa_attention`` leave values unchanged, and a per-rank program has no
global layout to hint at.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.collectives import all_gather, pmax, psum, sum_grad
from repro_torch.dist.sharding import spec_dims
from repro_torch.models.common import swiglu

_TOP = ("embed", "final_norm", "lm_head")
_WHOLE = (None, None)


class Layout:
    """One rank's reading of a parameter spec tree (``pspecs``, on blocks
    shaped as ``like``): which leaf is sharded where, and the model and
    data collectives that follow from it.  ``cfg`` is the model's
    ``LMConfig``; without ``mesh`` every leaf is whole."""

    def __init__(self, cfg, mesh=None, pspecs=None, like=None):
        self.cfg, self.mesh = cfg, mesh
        self.tp, self.r = 1, 0
        self.top, self.block = {}, {}
        if mesh is None:
            return
        self.tp, self.r = mesh.group_size("model"), mesh.group_rank("model")
        self.top = {k: spec_dims(pspecs[k], like[k].dim(), mesh) for k in _TOP if k in like}
        for pos, leaves in like["blocks"].items():
            dims = {}
            for name, w in leaves.items():
                md, dd = spec_dims(pspecs["blocks"][pos][name], w.dim(), mesh)
                if dd == 0:
                    raise ValueError(f"{name}: FSDP over the group dimension")
                dims[name] = (None if md is None else md - 1, None if dd is None else dd - 1)
            self.block[pos] = dims
            split = {n: d[0] is not None for n, d in dims.items()}
            if split["wq"] != split["wo"] or (split["wk"] and not split["wq"]):
                raise ValueError(f"{pos}: heads split inconsistently: {split}")
            if split["wk"] != split["wv"]:
                raise ValueError(f"{pos}: wk and wv split differently")
            for a, b in (("w_gate", "w_down"), ("w_up", "w_down"), ("ws_gate", "ws_down"),
                         ("ws_up", "ws_down")):
                if a in split and split[a] != split[b]:
                    raise ValueError(f"{pos}: {a} and {b} split differently")
            if cfg.moe and not split["we_gate"]:
                raise ValueError(f"{cfg.name}: {cfg.moe.n_experts} experts do not split over "
                                 f"{self.tp} model ranks")
        if cfg.moe:
            # the routed experts over this mesh; the layout gathers FSDP
            # leaves and runs the shared expert itself
            self.ep_cfg = dataclasses.replace(
                cfg, ep_mesh=mesh, ep_dp_axes=mesh.dp_axes, ep_fsdp=False,
                moe=dataclasses.replace(cfg.moe, shared_expert=False))

    # -- reading the specs ----------------------------------------------

    def _dims(self, pos: int, name: str) -> tuple:
        """(model dimension, data dimension) of a group's leaf, without the
        group dimension."""
        return self.block.get(f"pos{pos}", {}).get(name, _WHOLE)

    def split(self, pos: int, name: str) -> bool:
        """Whether sub-layer ``pos``'s leaf ``name`` is split over ``model``."""
        return self._dims(pos, name)[0] is not None

    def n_kv_heads(self, pos: int) -> int:
        """The KV heads this rank's cache holds at sub-layer ``pos``."""
        return self.cfg.n_kv_heads // (self.tp if self.split(pos, "wk") else 1)

    def _gather(self, w, dd):
        return w if dd is None else all_gather(w, self.mesh, "data", dd)

    def gather_top(self, params) -> dict:
        """``embed``, ``final_norm`` and ``lm_head`` gathered over ``data``
        where FSDP shards them."""
        return {k: self._gather(params[k], self.top.get(k, _WHOLE)[1])
                for k in _TOP if k in params}

    def gather_group(self, block) -> dict:
        """One group's leaves (``block[pos{p}][name]``, without the group
        dimension) gathered over ``data`` where FSDP shards them."""
        return {pos: {n: self._gather(w, self.block.get(pos, {}).get(n, _WHOLE)[1])
                      for n, w in leaves.items()}
                for pos, leaves in block.items()}

    # -- products -------------------------------------------------------

    def col(self, pos: int, name: str, h):
        """The input of a product with leaf ``name``: through Megatron's *f*
        where the leaf is split (column-parallel)."""
        return sum_grad(h, self.mesh, "model") if self.split(pos, name) else h

    def row(self, pos: int, name: str, y):
        """The output of a product with leaf ``name``: summed over
        ``model`` where the leaf is split (row-parallel)."""
        return psum(y, self.mesh, "model") if self.split(pos, name) else y

    def mlp(self, pos: int, p, h, gate: str, up: str, down: str):
        """A SwiGLU FFN, column- and row-parallel where its leaves are
        split."""
        return self.row(pos, down, swiglu(self.col(pos, gate, h), p[gate], p[up], p[down]))

    def kv_grad(self, pos: int, k):
        """k or v computed whole for query heads split over ``model``: each
        rank uses its heads' part, so the cotangent is summed over
        ``model``."""
        if self.split(pos, "wq") and not self.split(pos, "wk"):
            return sum_grad(k, self.mesh, "model")
        return k

    def kv_heads(self, pos: int, k):
        """k or v [B, S, K, Dh] whole, cut to the KV heads of this rank's
        query heads where ``wq`` is sharded and ``wk`` is not; as it is
        otherwise."""
        if not self.split(pos, "wq") or self.split(pos, "wk"):
            return k
        H, K = self.cfg.n_heads, self.cfg.n_kv_heads
        hl = H // self.tp
        idx = [h // (H // K) for h in range(self.r * hl, (self.r + 1) * hl)]
        lo, n = idx[0], idx[-1] + 1 - idx[0]
        if hl % n == 0 and all(i == lo + j // (hl // n) for j, i in enumerate(idx)):
            return k[:, :, lo:lo + n]
        return k[:, :, idx]

    def expert_rows(self, pos: int, ye, top):
        """Each token's row of its chosen expert, ye [E_loc, T, D] holding
        this rank's experts for every token: where the experts are split,
        the row kept where this rank holds the expert and summed over
        ``model`` (one row and zeros)."""
        rows = torch.arange(top.shape[0], device=top.device)
        if not self.split(pos, "we_gate"):
            return ye[top, rows]
        el = ye.shape[0]
        local = top - self.r * el
        inside = (local >= 0) & (local < el)
        y = ye[local.clamp(0, el - 1), rows]
        return psum(torch.where(inside[:, None], y, torch.zeros((), dtype=y.dtype,
                                                                  device=y.device)),
                    self.mesh, "model")

    # -- embedding and head ---------------------------------------------

    def embed(self, emb, tokens):
        """Rows of ``embed`` (its vocab block where sharded) at ``tokens``
        in the activation dtype."""
        if self.top.get("embed", _WHOLE)[0] != 0:
            return emb[tokens].to(self.cfg.act_dtype)
        rows = emb.shape[0]
        local = tokens.long() - self.r * rows
        inside = (local >= 0) & (local < rows)
        x = emb[local.clamp(0, rows - 1)]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        return psum(x, self.mesh, "model").to(self.cfg.act_dtype)

    def vocab_sharded(self) -> bool:
        """Whether the head (``lm_head`` [d, V/tp], or the tied ``embed``
        [V/tp, d]) is split over ``model`` on its vocab dimension."""
        if "lm_head" in self.top:
            return self.top["lm_head"][0] == 1
        return self.top.get("embed", _WHOLE)[0] == 0

    def require_vocab_split(self) -> None:
        """On a mesh, the serving logits are the rank's vocab block, as the
        logits' spec asks: refuse a head that does not split."""
        if self.mesh is not None and not self.vocab_sharded():
            raise ValueError(f"{self.cfg.name}: a vocab of {self.cfg.vocab} does not split over "
                             f"{self.tp} model ranks, as the logits' spec asks")

    def vocab_xent(self, x, head, labels, chunk: int = 512):
        """Mean cross entropy of x [B, S, D] @ head [D, V/tp] against
        labels [B, S], the head split over ``model`` (module docstring)."""
        mesh = self.mesh
        B, S, _ = x.shape
        V = head.shape[1]
        lo = self.r * V
        xf = sum_grad(x, mesh, "model")
        cb = min(chunk, S)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        count = 0
        for s0 in range(0, S, cb):
            width = min(cb, S - s0)
            logits = (xf[:, s0:s0 + width] @ head).float()
            m = pmax(logits.detach().amax(dim=-1), mesh, "model")
            se = psum(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, "model")
            lab = labels[:, s0:s0 + width].long() - lo
            inside = (lab >= 0) & (lab < V)
            gold = torch.gather(logits, -1, lab.clamp(0, V - 1)[..., None])[..., 0]
            gold = psum(torch.where(inside, gold, torch.zeros((), device=x.device)), mesh, "model")
            total = total + torch.sum(m + torch.log(se) - gold)
            count += B * width
        return total / count
