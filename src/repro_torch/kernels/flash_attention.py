"""Blocked (flash) attention: the Hopper kernel, its plain version and the
wrapper (counterpart of ``repro.kernels.flash_attention`` and
``repro.kernels.ops.flash_attention``).

``out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, hk, j]) @ v[b, hk]``
with ``scale = Dh^-0.5``, f32 arithmetic, ``hk = h // (H / H_kv)`` (GQA: the
plain version repeats the KV heads as the reference does, the kernel reads
the shared head), and under ``causal`` only keys ``j <= i + S_kv - S_q``.
The output has q's dtype.

The kernel (``csrc/model_kernels.cu``, ``flash_attention_kernel``) takes f32
and bf16, any S_q and S_kv (it masks the ragged tail itself) and head dims
up to 128.  The reference's wrapper hands shapes that are not a multiple of
its block to its plain reference; here every shape goes to the kernel.
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


def _check_shapes(q, k, v, causal):
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
    _check_shapes(q, k, v, causal)
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


def flash_attention(q, k, v, *, causal=True):
    """Attention of q [B, H, S_q, Dh] over k, v [B, H_kv, S_kv, Dh]
    (``H % H_kv == 0``); returns [B, H, S_q, Dh] in q's dtype, laid out as
    q is.  Tensors may be strided views (a [B, S, H, Dh] activation seen as
    [B, H, S, Dh]) as long as the last dimension is contiguous.

    On CUDA tensors this launches the kernel (counted in
    ``flash_attention.launches``); on CPU tensors it runs the plain
    version.  An empty output launches nothing."""
    dev = q.device
    if dev.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal)
    _check_shapes(q, k, v, causal)
    _build.check_operand("q", q, 4, dev, dtypes=DTYPES, inner_contiguous=True)
    for name, t in (("k", k), ("v", v)):
        _build.check_operand(name, t, 4, dev, dtypes=(q.dtype,), inner_contiguous=True)
    B, H, S_q, Dh = q.shape
    H_kv, S_kv = k.shape[1], k.shape[2]
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {Dh} > {MAX_HEAD_DIM}")
    if B * H > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: B * H = {B * H} > {MAX_BATCH_HEADS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, H_kv, S_q, S_kv, Dh, int(causal), int(q.dtype == torch.bfloat16),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
