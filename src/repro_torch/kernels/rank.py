"""Batched bitvector rank: the Hopper kernel, its plain version and the
wrapper (counterpart of ``repro.kernels.rank`` and ``repro.kernels.ops.rank``).

``rank1(i) = ones_prefix[i >> 5] + popcount(words[i >> 5] & ((1 << (i & 31)) - 1))``

The kernel (``csrc/retrieval_kernels.cu``, ``rank_kernel``) runs one thread
per query over ``rt::wm_rank1`` of ``retrieval_core.cuh``, the helper the
fused backward search calls once per level, so both kernels share one
definition of rank.
"""

from __future__ import annotations

import torch

from repro_torch.common import IDX, rank1_words
from repro_torch.kernels import _build
from repro_torch.kernels._record import record


def rank_plain(words, ones_prefix, idx):
    """Plain PyTorch version of the kernel (mirrors
    ``repro.kernels.ref.rank_ref``): int32[Q].  The mask is computed on
    unsigned values widened to int64, so ``i % 32 == 0`` masks every bit."""
    return rank1_words(words, ones_prefix, idx)


def rank(words, ones_prefix, idx):
    """Batched rank1 of int32[Q] positions ``idx`` over a packed bitvector
    (``words``: int32 bit patterns [W], ``ones_prefix``: int32[W]); every
    position lies in [0, 32 * W).  Returns int32[Q].

    On CUDA tensors this launches the kernel (counted in ``rank.launches``);
    on CPU tensors it runs the plain version.  ``Q == 0`` has a closed-form
    empty answer and launches nothing."""
    dev = idx.device
    if idx.shape[0]:
        record("rank", words, ones_prefix, idx)
    if dev.type != "cuda":
        return rank_plain(words, ones_prefix, idx)
    for name, t in (("words", words), ("ones_prefix", ones_prefix), ("idx", idx)):
        _build.check_operand(name, t, 1, dev)
    if ones_prefix.shape != words.shape:
        raise ValueError("rank: words and ones_prefix differ in shape")
    Q = idx.shape[0]
    out = torch.empty(Q, dtype=IDX, device=dev)
    if Q == 0:
        return out
    err = _build.library().rt_rank(
        words.data_ptr(), ones_prefix.data_ptr(), idx.data_ptr(), out.data_ptr(),
        Q, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "rank")
    rank.launches += 1
    return out


rank.launches = 0
