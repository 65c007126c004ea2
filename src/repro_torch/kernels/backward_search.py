"""Fused CSA backward search: the Hopper kernel, its plain version, and the
wrapper (counterpart of ``repro.kernels.backward_search`` and
``repro.kernels.ops.backward_search``).

The kernel (``csrc/retrieval_kernels.cu``, core in ``retrieval_core.cuh``)
runs one thread per query and reads the natural left-to-right pattern row
directly.  The plain version keeps the reference's layout: patterns
reversed into processing order (``reverse_patterns``), then a masked scan
over the symbol slots with a pair descent per slot.
"""

from __future__ import annotations

import torch

from repro_torch.common import IDX, rank1_words
from repro_torch.kernels import _build
from repro_torch.kernels._record import record


def reverse_patterns(patterns: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Right-to-left processing order of padded rows: slot t holds
    pattern[length-1-t] (clipped into the row)."""
    B, max_m = patterns.shape
    t = torch.arange(max_m, dtype=IDX, device=patterns.device)
    j = torch.clamp(lengths[:, None] - 1 - t[None, :], 0, max(max_m - 1, 0))
    return torch.gather(patterns, 1, j.to(torch.int64)) if max_m else patterns


def backward_search_plain(words, ones_prefix, zcount, base, rev_patterns,
                          lengths, *, n: int, sigma: int):
    """Plain PyTorch version of the kernel (mirrors
    ``repro.kernels.ref.backward_search_ref``): (lo int32[B], hi int32[B])."""
    levels = words.shape[0]
    B, max_m = rev_patterns.shape
    dev = rev_patterns.device
    lo = torch.zeros(B, dtype=IDX, device=dev)
    hi = torch.full((B,), n, dtype=IDX, device=dev)
    for t in range(max_m):
        c = rev_patterns[:, t]
        active = (t < lengths) & (lo < hi)
        c_ok = (c >= 0) & (c < sigma)
        cc = torch.clamp(c, 0, max(sigma - 1, 0))
        p, q = lo, hi
        for lvl in range(levels):
            bit = (cc >> (levels - 1 - lvl)) & 1
            z = zcount[lvl]
            r1p = rank1_words(words[lvl], ones_prefix[lvl], p)
            r1q = rank1_words(words[lvl], ones_prefix[lvl], q)
            p = torch.where(bit == 0, p - r1p, z + r1p)
            q = torch.where(bit == 0, q - r1q, z + r1q)
        b = base[cc]
        oob = torch.where(c < 0, 0, n).to(IDX)
        lo = torch.where(active, torch.where(c_ok, b + p, oob), lo).to(IDX)
        hi = torch.where(active, torch.where(c_ok, b + q, oob), hi).to(IDX)
    return lo, torch.maximum(lo, hi)


def backward_search(words, ones_prefix, zcount, base, patterns, lengths, *,
                    n: int, sigma: int):
    """Batched backward search of natural-order padded ``patterns``
    (int32[B, max_m]) with ``lengths`` (int32[B]): (lo int32[B], hi int32[B]).

    On CUDA tensors this launches the kernel (and counts the launch in
    ``backward_search.launches``); on CPU tensors it runs the plain
    version.  ``words`` are int32 bit patterns [levels, W+1];
    ``base[c] = counts[c] - sym_starts[c]``.
    """
    B, max_m = patterns.shape
    dev = patterns.device
    if B:  # B == 0 has a closed-form empty answer on the card
        record("backward_search", words, ones_prefix, zcount, base, patterns, lengths)
    if dev.type != "cuda":
        return backward_search_plain(
            words, ones_prefix, zcount, base,
            reverse_patterns(patterns, lengths), lengths, n=n, sigma=sigma,
        )
    for name, t, dims in (("words", words, 2), ("ones_prefix", ones_prefix, 2),
                          ("zcount", zcount, 1), ("base", base, 1),
                          ("patterns", patterns, 2), ("lengths", lengths, 1)):
        _build.check_operand(name, t, dims, dev)
    levels, stride = words.shape
    if (ones_prefix.shape != words.shape or zcount.shape[0] != levels
            or base.shape[0] != sigma or lengths.shape[0] != B):
        raise ValueError("backward_search: inconsistent operand shapes")
    lo = torch.empty(B, dtype=IDX, device=dev)
    hi = torch.empty(B, dtype=IDX, device=dev)
    if B == 0:
        return lo, hi
    err = _build.library().rt_backward_search(
        words.data_ptr(), ones_prefix.data_ptr(), zcount.data_ptr(),
        base.data_ptr(), patterns.data_ptr(), lengths.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), B, max_m, levels, stride, n, sigma,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "backward_search")
    backward_search.launches += 1
    return lo, hi


backward_search.launches = 0
