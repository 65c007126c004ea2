"""Gradient compression: block-wise int8 quantization with error feedback
(counterpart of ``repro.train.compression``).

Each leaf, plus its carried error, is cut into blocks of ``BLOCK`` values;
a block's scale is its largest magnitude over 127 (plus 1e-12), its payload
``round(x / scale)`` clipped to [-127, 127] as int8 (``torch.round`` rounds
half to even, as ``jnp.round``), and the error carried to the next step is
what the payload does not represent.  int8 with error feedback cuts the
gradient bytes 4x against f32 while the residual keeps the accumulated
quantization error in the update path (Seide et al. 2014; Karimireddy et
al. 2019)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.train.tree import flatten, map_leaves, unflatten

BLOCK = 256


def _blockwise_scale(g2d):
    return torch.amax(torch.abs(g2d), dim=-1, keepdim=True) / 127.0 + 1e-12


def compress_leaf(g, err):
    """(int8 payload [n_blocks, BLOCK], f32 scales [n_blocks, 1], new f32
    error shaped as g)."""
    flat = g.float().reshape(-1)
    n = flat.numel()
    x = F.pad(flat + err.reshape(-1), (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = _blockwise_scale(x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    new_err = (x - deq).reshape(-1)[:n].reshape(g.shape)
    return q, scale, new_err


def decompress_leaf(q, scale, shape):
    """The f32 values of payload q at ``scale``, cut to ``shape``."""
    return (q.float() * scale).reshape(-1)[:math.prod(shape)].reshape(shape)


def init_error_state(params) -> dict:
    """Zero f32 errors shaped as ``params``."""
    return map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params)


def compressed_grads(grads, err_state):
    """Quantize and dequantize every leaf with error feedback: (the
    gradients as seen after communication, in each gradient's dtype; the
    new error state)."""
    outs, errs = [], []
    for g, e in zip(flatten(grads)[0], flatten(err_state)[0]):
        q, s, ne = compress_leaf(g, e)
        outs.append(decompress_leaf(q, s, g.shape).to(g.dtype))
        errs.append(ne)
    return unflatten(grads, outs), unflatten(grads, errs)


def compression_ratio(grads) -> float:
    """Bytes of int8 payloads and f32 scales over the bytes of f32."""
    sizes = [leaf.numel() for leaf in flatten(grads)[0]]
    total_f32 = sum(n * 4 for n in sizes)
    total_c = sum(n + (n + BLOCK - 1) // BLOCK * 4 for n in sizes)
    return total_c / total_f32
