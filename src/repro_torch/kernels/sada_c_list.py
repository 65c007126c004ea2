"""Sada-C document listing: the Hopper kernel, its plain version and the
wrapper.  The kernel is the port's own: the reference runs
``repro.core.listing.sada_c_list_docs`` (Sadakane's RMQ recursion over
Muthukrishnan's C array with V-marking, the paper's Sada-C-D and Sada-C-L
baselines) in XLA.

The kernel (``sada_c_list_kernel`` in ``csrc/retrieval_kernels.cu``, core
``rt::sada_c_list_one`` in ``retrieval_core.cuh``) runs one warp per query,
one query a block, its interval stack and seen bitmap in the block's
shared memory, the rest of the SM's 256 KB left to L1.  Each
stack entry holds its interval's argmin and document, resolved when the
interval is pushed, so a pop reads only shared memory; a reported pop's
two children are resolved side by side, one per half-warp.  DA[k] is read
from a stored document array (at both RMQ candidates, beside their
values) or located through the CSA, with every binary search of the
locate a 16-way search by the half-warp (one template each).  The plain
version advances the whole batch in lockstep, one pop per query an
iteration.  Both replay the reference's trajectory (stack cap max_df + 4,
2 max_df + 8 pops counting invalid ones, pushes right then left) and
report documents in discovery order, so their integers are identical.
The kernel is compiled and run only on the card, by ``chip_smoke.py`` and
``scripts/sada_c_ab.py``.
"""

from __future__ import annotations

import torch

from repro_torch.common import IDX
from repro_torch.core.csa import CSA, doc_at
from repro_torch.kernels import _build
from repro_torch.kernels._record import record
from repro_torch.kernels.csa_view import check_csa_operands
from repro_torch.kernels.ilcp_list import pop_cap, stack_cap
from repro_torch.kernels.rmq import rmq_plain

def shared_bytes_per_warp(d: int, max_df: int) -> int:
    """One interval stack of ``stack_cap(max_df)`` entries of four int32
    (interval, argmin, document) and the seen bitmap rounded to 16 bytes,
    per warp (``rt::sada_c_shared_ints``)."""
    return 4 * (4 * stack_cap(max_df) + -(-d // 128) * 4)


def sada_c_list_plain(values, table, da, lo, hi, *, d: int, max_df: int):
    """Plain PyTorch version of the kernel: the batch in lockstep, one pop
    per live query an iteration, the argmin by the plain sparse-table RMQ
    over ``values`` (C), DA[k] from the source ``da`` (a stored int32[n]
    array or a CSA).  Syncs with the host once per iteration.  Returns
    (docs int32[B, max_df] padded -1, cnt int32[B])."""
    n = values.shape[0]
    B = lo.shape[0]
    dev = lo.device
    cap, max_pops = stack_cap(max_df), pop_cap(max_df)
    rows = torch.arange(B, device=dev)

    def z():
        return torch.zeros(B, dtype=IDX, device=dev)

    sa = torch.zeros((B, cap), dtype=IDX, device=dev)
    sb = torch.zeros((B, cap), dtype=IDX, device=dev)
    sa[:, 0] = lo
    sb[:, 0] = hi - 1
    sp = torch.ones(B, dtype=IDX, device=dev)
    cnt, pops = z(), z()
    V = torch.zeros((B, max(d, 1)), dtype=torch.bool, device=dev)
    docs = torch.full((B, max_df + 1), -1, dtype=IDX, device=dev)
    while True:
        live = (sp > 0) & (cnt < max_df) & (pops < max_pops)
        if not bool(live.any()):
            break
        top = torch.clamp(sp - 1, min=0).long()
        a, b = sa[rows, top], sb[rows, top]
        sp = torch.where(live, sp - 1, sp)
        pops = torch.where(live, pops + 1, pops)
        valid = live & (a <= b) & (lo < hi)
        # the reference clamps to hi - 1; into [0, n) too, so masked rows
        # read in bounds (their answer does not depend on it)
        k = rmq_plain(values, table, torch.clamp(torch.minimum(a, hi - 1), 0, n - 1),
                      torch.clamp(torch.minimum(b, hi - 1), 0, n - 1))
        g = doc_at(da, k)
        gc = torch.clamp(g, 0, max(d - 1, 0)).long()
        rep = valid & ~V[rows, gc]
        V[rows, gc] = V[rows, gc] | rep
        slot = torch.where(rep, cnt, max_df).long()
        docs[rows, slot] = torch.where(rep, g, docs[rows, slot])
        cnt = torch.where(rep, cnt + 1, cnt)
        for x, y in ((k + 1, b), (a, k - 1)):
            do = rep & (x <= y) & (sp < cap)
            slot = torch.clamp(sp, max=cap - 1).long()
            sa[rows, slot] = torch.where(do, x, sa[rows, slot])
            sb[rows, slot] = torch.where(do, y, sb[rows, slot])
            sp = torch.where(do, sp + 1, sp)
    return docs[:, :max_df], cnt


def sada_c_list(values, table, da, lo, hi, *, d: int, max_df: int):
    """Sada-C listing over SA ranges [lo, hi) (int32[B] each): the leftmost
    argmin of C through its sparse table (``values`` int32[n], ``table``
    int32[levels, n]), DA from ``da``, a stored int32[n] array (Sada-C-D)
    or a CSA (Sada-C-L).  Returns (docs int32[B, max_df] padded -1 in
    discovery order, cnt int32[B]).

    On CUDA tensors this launches the kernel (counted in
    ``sada_c_list.launches``, or ``sada_c_list.csa_launches`` for a CSA
    source); on CPU tensors it runs the plain version.  ``B == 0``,
    ``max_df <= 0`` and ``d <= 0`` have a closed-form empty answer and
    launch nothing."""
    B = lo.shape[0]
    dev = lo.device
    if B == 0 or max_df <= 0 or d <= 0:
        return (torch.full((B, max(max_df, 0)), -1, dtype=IDX, device=dev),
                torch.zeros(B, dtype=IDX, device=dev))
    record("sada_c_list", values, table, da, lo, hi)
    if dev.type != "cuda":
        return sada_c_list_plain(values, table, da, lo, hi, d=d, max_df=max_df)
    for name, t, dims in (("values", values, 1), ("table", table, 2),
                          ("lo", lo, 1), ("hi", hi, 1)):
        _build.check_operand(name, t, dims, dev)
    levels, n = table.shape
    if values.shape[0] != n or hi.shape[0] != B:
        raise ValueError("sada_c_list: inconsistent operand shapes")
    # one query (warp) a block: more warps share one SM's L1, and at phase
    # 7's shape four a block took 1.04-1.05x one's time on the CSA locate
    # (PERF.md, row 8)
    if shared_bytes_per_warp(d, max_df) > _build.MAX_SHARED_BYTES:
        raise ValueError(f"sada_c_list: max_df={max_df} and d={d} need "
                         f"{shared_bytes_per_warp(d, max_df)} bytes of shared memory per "
                         f"query, over the card's {_build.MAX_SHARED_BYTES}")
    docs = torch.empty((B, max_df), dtype=IDX, device=dev)
    cnt = torch.empty(B, dtype=IDX, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ops = (table.data_ptr(), values.data_ptr())
    outs = (lo.data_ptr(), hi.data_ptr(), docs.data_ptr(), cnt.data_ptr())
    if isinstance(da, CSA):
        if da.n != n:
            raise ValueError("sada_c_list: the CSA and C differ in length")
        ptrs, ints = check_csa_operands(da, dev)
        err = _build.library().rt_sada_c_list_csa(*ptrs, *ops, *outs, *ints, B, levels, d,
                                                  max_df, 1, stream)
        _build.check(err, "sada_c_list[csa]")
        sada_c_list.csa_launches += 1
        return docs, cnt
    _build.check_operand("da", da, 1, dev)
    if da.shape[0] != n:
        raise ValueError("sada_c_list: DA and C differ in length")
    err = _build.library().rt_sada_c_list(*ops, da.data_ptr(), *outs, B, levels, n, d,
                                          max_df, 1, stream)
    _build.check(err, "sada_c_list")
    sada_c_list.launches += 1
    return docs, cnt


sada_c_list.launches = 0
sada_c_list.csa_launches = 0
