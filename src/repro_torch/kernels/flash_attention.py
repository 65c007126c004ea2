"""Blocked (flash) attention: the Hopper kernel, its plain version and the
wrapper (counterpart of ``repro.kernels.flash_attention`` and
``repro.kernels.ops.flash_attention``).

``out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, hk, j]) @ v[b, hk]``
with ``scale = Dh^-0.5``, f32 arithmetic, ``hk = h // (H / H_kv)`` (GQA: the
plain version repeats the KV heads as the reference does, the kernel reads
the shared head), and under ``causal`` only keys ``j <= i + S_kv - S_q``.
The output has q's dtype.

Two hand-written kernels serve the card, chosen by ``flash_route``, a rule
on the operands (not a fallback: nothing catches a failed build or launch):

- ``"hopper"`` (``csrc/flash_hopper.cu``, ``flash_hopper_kernel``): bf16
  operands that TMA can describe; TMA-fed K/V tiles, ``wgmma`` products and
  a split P that keeps the reference's f32 P to within one bf16 rounding.
- ``"simt"`` (``csrc/model_kernels.cu``, ``flash_attention_kernel``): f32
  (``wgmma`` has no f32 input, and TF32 would not hold the f32 tolerance)
  and bf16 views that TMA cannot take; products in f32 on CUDA cores.

Both take any S_q and S_kv (they mask the ragged tail themselves) and head
dims up to 128.  The reference's wrapper hands shapes that are not a
multiple of its block to its plain reference; here every shape goes to a
kernel.

The gradient is the reference's design (``_flash_diff``, ``_flash_fwd``,
``_flash_bwd``): ``_FlashFunction`` runs the same forward (kernel or plain
version, same route rule and counters) and saves q, k and v; its backward
is ``flash_attention_vjp``, the recompute VJP of the reference's plain
attention, in plain tensor code blockwise over query blocks.  The
reference has no backward kernel, so neither has the port.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: the largest head dimension the kernel takes
MAX_HEAD_DIM = 128
#: dtypes the kernel takes
DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's grid puts batch x heads on its second axis
MAX_BATCH_HEADS = 65535
#: the routes of ``flash_route``
ROUTES = ("hopper", "simt")
#: TMA takes base addresses and strides in multiples of 16 bytes
TMA_ALIGN = 16


def _check_shapes(q, k, v, *, causal):
    """Shapes shared by both versions; raises ValueError."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, S, Dh]")
    B, H, S_q, Dh = q.shape
    Bk, H_kv, S_kv, Dk = k.shape
    if k.shape != v.shape or Bk != B or Dk != Dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not agree")
    if H_kv == 0 or H % H_kv:
        raise ValueError(f"flash_attention: {H} query heads over {H_kv} KV heads")
    if causal and S_kv < S_q:
        # the Pallas kernel (mean of V over fully masked rows) and its
        # reference (NaN) disagree here, and no caller asks for it
        raise ValueError(f"flash_attention: causal attention needs S_kv >= S_q, got "
                         f"S_q={S_q}, S_kv={S_kv}")


def flash_attention_plain(q, k, v, *, causal=True, q_block=1024):
    """Plain PyTorch version (the semantics of
    ``repro.kernels.ref.flash_attention_ref``): f32 logits scaled after the
    product, ``-inf`` outside the causal mask, softmax, f32 PV, one cast to
    q's dtype.  Blockwise over ``q_block`` query rows, so that the
    [q_block, S_kv] score tiles fit for long sequences."""
    _check_shapes(q, k, v, causal=causal)
    B, H, S_q, Dh = q.shape
    H_kv, S_kv = k.shape[1], k.shape[2]
    rep = H // H_kv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scale = Dh ** -0.5
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kpos = torch.arange(S_kv, device=q.device)
    for s0 in range(0, S_q, q_block):
        s1 = min(s0 + q_block, S_q)
        logits = torch.matmul(q[:, :, s0:s1].float(), kf.transpose(-1, -2)) * scale
        if causal:
            qpos = torch.arange(s0, s1, device=q.device)[:, None] + (S_kv - S_q)
            logits = logits.masked_fill(kpos[None, :] > qpos, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out[:, :, s0:s1] = torch.matmul(probs, vf).to(q.dtype)
    return out


def flash_route(q, k, v) -> str:
    """The kernel that takes these operands on the card: ``"hopper"`` when
    q, k and v are all bf16 4-D tensors with a contiguous last dimension of
    at most ``MAX_HEAD_DIM``, no empty dimension, and every base address and
    every batch, head and row stride a multiple of ``TMA_ALIGN`` bytes (a
    dimension of size 1 has no stride to check); ``"simt"`` otherwise (f32,
    or a view TMA cannot describe).  Pure: reads shapes, strides, dtypes and
    addresses only."""
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.dim() != 4 or 0 in t.shape:
            return "simt"
        if t.shape[-1] > MAX_HEAD_DIM or (t.stride(-1) != 1 and t.shape[-1] > 1):
            return "simt"
        if t.data_ptr() % TMA_ALIGN:
            return "simt"
        if any(n > 1 and (st * t.element_size()) % TMA_ALIGN
               for n, st in zip(t.shape[:3], t.stride()[:3])):
            return "simt"
    return "hopper"


def _tma_strides(t):
    """Element strides of t's batch, head and row dimensions for a tensor
    map; a dimension of size 1 is never stepped, so it gets the smallest
    stride TMA takes."""
    step = TMA_ALIGN // t.element_size()
    return [st if n > 1 else step for n, st in zip(t.shape[:3], t.stride()[:3])]


def flash_attention_vjp(q, k, v, g, *, causal=True, q_block=1024):
    """(dq, dk, dv) of ``flash_attention_plain`` at q, k, v for the output
    gradient g (the reference's ``_flash_bwd``: ``jax.vjp`` of its plain
    attention), each in its operand's dtype.  Recomputes each block of
    ``q_block`` query rows' f32 logits and softmax, takes the block's dq and
    adds its share to dk and dv in f32, so one [B, H, q_block, S_kv] tile is
    live, not S_q x S_kv.  A KV head's dk and dv sum over the query heads of
    its group, as autograd through the plain version's
    ``repeat_interleave`` does."""
    _check_shapes(q, k, v, causal=causal)
    if g.shape != q.shape:
        raise ValueError(f"flash_attention_vjp: gradient {tuple(g.shape)} is not the output's "
                         f"{tuple(q.shape)}")
    B, H, S_q, Dh = q.shape
    H_kv, S_kv = k.shape[1], k.shape[2]
    rep = H // H_kv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scale = Dh ** -0.5
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dkf = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dvf = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    kpos = torch.arange(S_kv, device=q.device)
    for s0 in range(0, S_q, q_block):
        s1 = min(s0 + q_block, S_q)
        qb, gb = q[:, :, s0:s1].float(), g[:, :, s0:s1].float()
        logits = torch.matmul(qb, kf.transpose(-1, -2)).mul_(scale)
        if causal:
            qpos = torch.arange(s0, s1, device=q.device)[:, None] + (S_kv - S_q)
            logits.masked_fill_(kpos[None, :] > qpos, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        del logits
        dvf += torch.matmul(probs.transpose(-1, -2), gb)
        # softmax's VJP, as jax.nn.softmax's: probs * (dp - sum(dp * probs)),
        # then the logits' scale; written into dp's tile
        ds = torch.matmul(gb, vf.transpose(-1, -2))
        ds.sub_((ds * probs).sum(-1, keepdim=True)).mul_(probs).mul_(scale)
        del probs
        dq[:, :, s0:s1] = torch.matmul(ds, kf).to(q.dtype)
        dkf += torch.matmul(ds.transpose(-1, -2), qb)
    dk = dkf.view(B, H_kv, rep, S_kv, Dh).sum(2).to(k.dtype)
    dv = dvf.view(B, H_kv, rep, S_kv, Dh).sum(2).to(v.dtype)
    return dq, dk, dv


class _FlashFunction(torch.autograd.Function):
    """The differentiable flash attention (the reference's ``_flash_diff``):
    the forward of ``flash_attention`` (the kernel on CUDA tensors, the plain
    version on CPU tensors), q, k and v saved as ``_flash_fwd`` saves its
    residuals, and ``flash_attention_vjp`` as the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, route=None):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _forward(q, k, v, causal=causal, route=route)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_vjp(q, k, v, g, causal=ctx.causal), None, None)


def flash_attention(q, k, v, *, causal=True, route=None):
    """Attention of q [B, H, S_q, Dh] over k, v [B, H_kv, S_kv, Dh]
    (``H % H_kv == 0``); returns [B, H, S_q, Dh] in q's dtype, laid out as
    q is.  Tensors may be strided views (a [B, S, H, Dh] activation seen as
    [B, H, S, Dh]) as long as the last dimension is contiguous.

    On CUDA tensors this launches the kernel that ``flash_route`` names, or
    the one ``route`` names ("simt" takes every operand; "hopper" raises
    ValueError where ``flash_route`` says "simt").  Every launch counts in
    ``flash_attention.launches``, the Hopper kernel's also in
    ``flash_attention.hopper_launches``.  On CPU tensors it runs the plain
    version.  An empty output launches nothing.

    When grad mode is on and an operand requires grad, the call goes through
    ``_FlashFunction``: the same forward, differentiable by
    ``flash_attention_vjp``."""
    if route not in (None, *ROUTES):
        raise ValueError(f"flash_attention: route {route!r} is none of {ROUTES}")
    differentiable = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if differentiable:
        return _FlashFunction.apply(q, k, v, causal, route)
    return _forward(q, k, v, causal=causal, route=route)


def _forward(q, k, v, *, causal, route):
    """``flash_attention``'s forward: the kernel on CUDA tensors, the plain
    version on CPU tensors; never recorded by autograd."""
    dev = q.device
    if dev.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal)
    _check_shapes(q, k, v, causal=causal)
    _build.check_operand("q", q, 4, dev, dtypes=DTYPES, inner_contiguous=True)
    for name, t in (("k", k), ("v", v)):
        _build.check_operand(name, t, 4, dev, dtypes=(q.dtype,), inner_contiguous=True)
    B, H, S_q, Dh = q.shape
    H_kv, S_kv = k.shape[1], k.shape[2]
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {Dh} > {MAX_HEAD_DIM}")
    if B * H > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: B * H = {B * H} > {MAX_BATCH_HEADS}")
    chosen = flash_route(q, k, v)
    if route == "hopper" and chosen != "hopper":
        raise ValueError("flash_attention: TMA cannot take these views (flash_route says "
                         "'simt'): bf16, 16-byte aligned base addresses and strides needed")
    route = route or chosen
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "hopper":
        err = _build.library().rt_flash_hopper(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, H_kv, S_q, S_kv, Dh, int(causal),
            *_tma_strides(q), *_tma_strides(k), *_tma_strides(v), *out.stride()[:3], stream,
        )
        _build.check(err, "flash_attention (hopper)")
        flash_attention.hopper_launches += 1
    else:
        err = _build.library().rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, H_kv, S_q, S_kv, Dh, int(causal), int(q.dtype == torch.bfloat16),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], stream,
        )
        _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.hopper_launches = 0
