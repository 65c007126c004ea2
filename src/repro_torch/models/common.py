"""Shared model building blocks (counterpart of ``repro.models.common``):
initializers, RMS norm, rotary embeddings, SwiGLU, MLPs and the mean
cross entropy.  The LM's own loss is ``models.transformer._chunked_xent``;
the recsys models use ``normal_init`` and ``mlp``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import resolve_device


def normal_init(generator: torch.Generator, shape, dtype, scale=0.02, device="cuda"):
    """N(0, scale^2) of ``shape`` in ``dtype`` on ``device``, drawn from
    ``generator`` (a generator of that device).  The reference's
    distribution; its random numbers differ (``jax.random``)."""
    t = torch.empty(shape, dtype=dtype, device=resolve_device(device))
    return t.normal_(0.0, scale, generator=generator)


def rms_norm(x, weight, eps=1e-6):
    """RMS norm in f32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float = 500000.0, device=None):
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, theta: float = 500000.0):
    """x: [..., S, H, Dh]; positions: integers broadcastable to [..., S].
    Rotates the two halves of the head dimension (not interleaved pairs),
    with f32 angles."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN: silu(x @ w_gate) * (x @ w_up) @ w_down."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def mlp(x, weights, biases, act=F.relu, final_act=None):
    """Plain MLP over lists of weights [d_in, d_out] and biases [d_out]:
    ``act`` between layers, ``final_act`` (if any) after the last."""
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = h @ w + b
        if i < len(weights) - 1:
            h = act(h)
        elif final_act is not None:
            h = final_act(h)
    return h


def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross entropy in f32.  logits [..., V], labels
    integers [...]; with ``mask``, the mean over its nonzero positions (at
    least one)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0]
    if mask is None:
        return -torch.mean(ll)
    mask = mask.float()
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
