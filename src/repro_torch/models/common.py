"""Shared model building blocks (counterpart of ``repro.models.common``):
RMS norm, rotary embeddings, SwiGLU.  The LM's loss is
``models.transformer._chunked_xent``; ``normal_init``, ``mlp`` and
``softmax_xent`` wait for the recsys models (ROADMAP A12.4)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
