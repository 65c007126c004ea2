"""Wavelet-tree document listing: the Hopper kernel, its plain version and
the wrapper.  The kernel is the port's own: the reference runs
``repro.core.wtlist.wt_list_docs`` (the WT baseline of Section 6.2.1) in
XLA.

Both walk the wavelet matrix of DA left first: a nonempty internal node
(level, lo, hi, prefix) at level l pushes its 1-child [z_l + rank1(lo),
z_l + rank1(hi)) and then its 0-child [rank0(lo), rank0(hi)), each if
nonempty, so smaller ids pop first; a nonempty leaf emits its prefix, the
document, with frequency hi - lo.  Documents come out ascending, at most
``max_df`` of them.  The kernel (``wt_list_kernel`` in
``csrc/retrieval_kernels.cu``, core ``rt::wt_list_one``) runs one thread
per query with a stack of levels + 2 entries; the reference's stack of
max_df (levels + 1) + 4 entries and its cap of 4 max_df (levels + 1) + 16
pops never bind (the core's comment says why; ``stack_size`` and
``pop_bound`` here), so neither version keeps them.
"""

from __future__ import annotations

import torch

from repro_torch.common import IDX, popcount32, u32
from repro_torch.kernels import _build
from repro_torch.kernels._record import record

#: stack entries of the kernel's threads (``rt::kWtStack``)
KERNEL_STACK = 34


def stack_size(levels: int) -> int:
    """Stack entries a query can need: levels + 1, plus one spare."""
    return levels + 2


def pop_bound(levels: int, count: int) -> int:
    """Most pops of a query that emitted ``count`` documents."""
    return max(1, count * (levels + 1))


def _rank1(words, prefix, lvl, pos):
    """Ones in bits [0, pos) of level ``lvl`` (int32[B] each), per row."""
    pos = pos.to(torch.int64)
    w = pos >> 5
    lv = lvl.to(torch.int64)
    mask = (torch.ones_like(pos) << (pos & 31)) - 1
    pc = popcount32(u32(words[lv, w]) & mask)
    return (prefix[lv, w].to(torch.int64) + pc).to(IDX)


def wt_list_plain(words, prefix, zcount, lo, hi, *, max_df: int):
    """Plain PyTorch version of the kernel: the batch in lockstep, one pop
    per live query an iteration.  Syncs with the host once per iteration.
    Returns (docs int32[B, max_df] padded -1, freqs int32[B, max_df] padded
    0, cnt int32[B])."""
    levels = words.shape[0]
    B = lo.shape[0]
    dev = lo.device
    size = stack_size(levels)
    rows = torch.arange(B, device=dev)
    st = torch.zeros((B, size, 4), dtype=IDX, device=dev)  # level, lo, hi, prefix
    st[:, 0, 1] = lo
    st[:, 0, 2] = hi
    sp = torch.ones(B, dtype=IDX, device=dev)
    cnt = torch.zeros(B, dtype=IDX, device=dev)
    docs = torch.full((B, max_df + 1), -1, dtype=IDX, device=dev)
    freqs = torch.zeros((B, max_df + 1), dtype=IDX, device=dev)
    while True:
        live = (sp > 0) & (cnt < max_df)
        if not bool(live.any()):
            break
        top = torch.clamp(sp - 1, min=0).long()
        lvl, a, b, val = st[rows, top].unbind(1)
        sp = torch.where(live, sp - 1, sp)
        nonempty = live & (a < b)
        emit = nonempty & (lvl >= levels)
        slot = torch.where(emit, cnt, max_df).long()
        docs[rows, slot] = torch.where(emit, val, docs[rows, slot])
        freqs[rows, slot] = torch.where(emit, b - a, freqs[rows, slot])
        cnt = torch.where(emit, cnt + 1, cnt)
        inner = nonempty & (lvl < levels)
        lc = torch.clamp(lvl, max=levels - 1)
        r1a, r1b = _rank1(words, prefix, lc, a), _rank1(words, prefix, lc, b)
        z = zcount[lc.long()]
        for x, y, bit in ((z + r1a, z + r1b, 1), (a - r1a, b - r1b, 0)):
            do = inner & (x < y)
            slot = torch.clamp(sp, max=size - 1).long()
            entry = torch.stack([lvl + 1, x, y, (val << 1) | bit], 1)
            st[rows, slot] = torch.where(do[:, None], entry, st[rows, slot])
            sp = torch.where(do, sp + 1, sp)
    return docs[:, :max_df], freqs[:, :max_df], cnt


def wt_list(words, prefix, zcount, lo, hi, *, max_df: int):
    """Distinct documents of DA[lo, hi) with their frequencies, for SA
    ranges (int32[B] each), through the DA wavelet matrix's levels
    (``words``, ``prefix``: int32[levels, W + 1]; ``zcount``:
    int32[levels]): (docs int32[B, max_df] ascending, -1 padded; freqs
    int32[B, max_df], 0 padded; cnt int32[B]).

    On CUDA tensors this launches the kernel (counted in
    ``wt_list.launches``); on CPU tensors it runs the plain version.
    ``B == 0`` and ``max_df <= 0`` have a closed-form empty answer and
    launch nothing."""
    B = lo.shape[0]
    dev = lo.device
    if B == 0 or max_df <= 0:
        return (torch.full((B, max(max_df, 0)), -1, dtype=IDX, device=dev),
                torch.zeros((B, max(max_df, 0)), dtype=IDX, device=dev),
                torch.zeros(B, dtype=IDX, device=dev))
    record("wt_list", words, prefix, zcount, lo, hi)
    if dev.type != "cuda":
        return wt_list_plain(words, prefix, zcount, lo, hi, max_df=max_df)
    for name, t, dims in (("words", words, 2), ("prefix", prefix, 2),
                          ("zcount", zcount, 1), ("lo", lo, 1), ("hi", hi, 1)):
        _build.check_operand(name, t, dims, dev)
    levels, stride = words.shape
    if prefix.shape != words.shape or zcount.shape[0] != levels or hi.shape[0] != B:
        raise ValueError("wt_list: inconsistent operand shapes")
    if stack_size(levels) > KERNEL_STACK:
        raise ValueError(f"wt_list: {levels} levels exceed the kernel's stack")
    docs = torch.empty((B, max_df), dtype=IDX, device=dev)
    freqs = torch.empty((B, max_df), dtype=IDX, device=dev)
    cnt = torch.empty(B, dtype=IDX, device=dev)
    err = _build.library().rt_wt_list(
        words.data_ptr(), prefix.data_ptr(), zcount.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        docs.data_ptr(), freqs.data_ptr(), cnt.data_ptr(), B, levels, stride, max_df,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "wt_list")
    wt_list.launches += 1
    return docs, freqs, cnt


wt_list.launches = 0
