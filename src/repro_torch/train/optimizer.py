"""AdamW (counterpart of ``repro.train.optimizer``).

Moments live in a configurable dtype (f32 by default; bf16 where f32
moments would not fit).  The update computes in f32 in the reference's
order and casts the new parameter back to its dtype and the moments to
``moment_dtype``.  The state is ``{"m": tree, "v": tree, "step": int32
0-d tensor}``; the update is functional (new tensors, nothing in place),
as the reference's."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.train.tree import flatten, map_leaves, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32
    grad_clip: float | None = 1.0


def adamw_init(params, cfg: AdamWConfig | None = None) -> dict:
    """Zero moments shaped as ``params`` (on their devices) and step 0."""
    cfg = cfg if cfg is not None else AdamWConfig()
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)  # noqa: E731
    leaves, _ = flatten(params)
    device = leaves[0].device if leaves else None
    return {"m": map_leaves(zeros, params), "v": map_leaves(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_shapes(params, cfg: AdamWConfig | None = None) -> dict:
    """The optimizer state's shapes and dtypes without allocation (the
    reference's ``abstract_opt_state``): a tree of ``meta`` tensors, usable
    as ``restore_checkpoint``'s ``like_tree``."""
    meta = map_leaves(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
    return adamw_init(meta, cfg)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``flatten``'s order) of each leaf's
    sum of f32 squares."""
    total = 0
    for leaf in flatten(tree)[0]:
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, norm=None) -> tuple[dict, dict]:
    """One AdamW step: (new params, new state).  With ``grad_clip``, the
    gradients are scaled by min(1, clip / max(norm, 1e-9)), the scale kept
    in f32 and cast to each gradient's dtype.  ``norm`` is the gradients'
    global norm where ``grads`` is one rank's shards of a larger tree
    (default: ``global_norm(grads)``)."""
    step = state["step"] + 1
    if cfg.grad_clip is not None:
        gn = global_norm(grads) if norm is None else norm
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
        grads = map_leaves(lambda g: g * scale.to(g.dtype), grads)

    c1 = 1.0 - torch.pow(cfg.b1, step.float())
    c2 = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        gf = g.float()
        mf = m.float() * cfg.b1 + gf * (1 - cfg.b1)
        vf = v.float() * cfg.b2 + gf * gf * (1 - cfg.b2)
        mhat = mf / c1
        vhat = vf / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        newp = (p.float() - cfg.lr * delta).to(p.dtype)
        return newp, mf.to(m.dtype), vf.to(v.dtype)

    flat_p, _ = flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, flatten(grads)[0], flatten(state["m"])[0], flatten(state["v"])[0])]
    new_params = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_params, {"m": new_m, "v": new_v, "step": step}
