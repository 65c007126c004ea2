"""Fused ILCP document listing: the Hopper kernel, its plain version and
the wrappers (counterpart of ``repro.kernels.ilcp_list`` and of
``repro.kernels.ops.runs_of`` / ``ops.ilcp_list``).

The kernel (``csrc/retrieval_kernels.cu``, core in ``retrieval_core.cuh``)
runs the Fig-1 recursion of ``repro.core.ilcp.ilcp_list_docs`` with one
warp per query, its stacks and seen-document bitmap in shared memory and
each run's document positions tested 32 at a time.  The plain version is the reference's batch-lockstep
POP/SCAN machine (``repro.kernels.ref.ilcp_list_ref``) in PyTorch.  Both
replay the per-query trajectory (pop order, push filters, truncation) and
report documents in discovery order, so their integers are identical.

The DA source is a stored document array (Sada-I-D) or a CSA (Sada-I-L:
the kernel instantiated on ``rt::DaLocate``, each lane locating its own
position of a run's chunk; the plain version reads ``core.csa.doc_at``).
"""

from __future__ import annotations

import torch

from repro_torch.common import IDX, searchsorted_i32
from repro_torch.core.csa import CSA, doc_at
from repro_torch.kernels import _build
from repro_torch.kernels._record import record
from repro_torch.kernels.csa_view import check_csa_operands
from repro_torch.kernels.rmq import rmq_plain


def stack_cap(max_df: int) -> int:
    return max_df + 4


def pop_cap(max_df: int) -> int:
    return 2 * max_df + 8


def lockstep_iteration_cap(max_df: int) -> int:
    """Ceiling on lockstep iterations of the plain version (the
    reference's bound; the loop normally exits on the all-done test)."""
    return 5 * max_df + 36


def runs_of(run_starts: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Run index containing ILCP position ``pos``; ``pos = -1`` maps to
    run -1."""
    return searchsorted_i32(run_starts[:-1], pos, right=True) - 1


def ilcp_list_plain(vilcp, table, run_starts, da, lo, hi, lo_run, hi_run, *,
                    d: int, max_df: int, rmq_fn=None):
    """Plain PyTorch version of the kernel: the whole batch advances in
    lockstep; an iteration either pops an interval and resolves its
    leftmost-min run (POP) or visits one DA position (SCAN), read from
    the DA source ``da`` (a stored int32[n] array or a CSA).  ``V`` is a
    [B, d] bool matrix; writes that the reference drops go to one extra
    column that is sliced off.  Syncs with the host once per iteration.

    ``rmq_fn(a, b)`` resolves the popped intervals of the whole batch,
    once per iteration (the reference's ``ilcp_list_ref(rmq_fn=)``); the
    default is the plain sparse-table RMQ.  Returns (docs int32[B, max_df]
    padded -1, cnt int32[B])."""
    rho = table.shape[1]
    B = lo.shape[0]
    dev = lo.device
    cap = stack_cap(max_df)
    iter_cap = pop_cap(max_df)
    rows = torch.arange(B, device=dev)
    if rmq_fn is None:
        def rmq_fn(a, b):
            return rmq_plain(vilcp, table, a, b)

    def z():
        return torch.zeros(B, dtype=IDX, device=dev)

    done = torch.zeros(B, dtype=torch.bool, device=dev)
    scan = torch.zeros(B, dtype=torch.bool, device=dev)
    a, b, i_run, k, j, cnt, pops = z(), z(), z(), z(), z(), z(), z()
    sp = torch.ones(B, dtype=IDX, device=dev)
    sa = torch.zeros((B, cap), dtype=IDX, device=dev)
    sb = torch.zeros((B, cap), dtype=IDX, device=dev)
    sa[:, 0] = lo_run
    sb[:, 0] = hi_run
    V = torch.zeros((B, max(d, 1)), dtype=torch.bool, device=dev)
    docs = torch.full((B, max_df), -1, dtype=IDX, device=dev)

    it = 0
    while bool((~done).any()) and it < lockstep_iteration_cap(max_df):
        # -- POP: take the top interval, resolve its leftmost-min run
        in_pop = ~done & ~scan
        can_pop = in_pop & (sp > 0) & (cnt < max_df) & (pops < iter_cap)
        done = done | (in_pop & ~can_pop)
        top = torch.clamp(sp - 1, min=0).long()
        a = torch.where(can_pop, sa[rows, top], a)
        b = torch.where(can_pop, sb[rows, top], b)
        sp = torch.where(can_pop, sp - 1, sp)
        pops = torch.where(can_pop, pops + 1, pops)

        valid = can_pop & (a <= b) & (lo < hi)
        r = rmq_fn(torch.clamp(a, 0, rho - 1), torch.clamp(b, 0, rho - 1))
        i_run = torch.where(valid, r, i_run)
        k = torch.where(valid, torch.maximum(lo, run_starts[torch.clamp(r, 0, rho - 1)]), k)
        j = torch.where(valid, torch.minimum(hi, run_starts[torch.clamp(r + 1, 0, rho)]), j)
        scan = scan | valid

        # -- SCAN: visit one DA position of the current run
        scanning = ~done & scan
        proc = scanning & (k < j) & (cnt < max_df)
        g = doc_at(da, k)
        gc = torch.clamp(g, 0, max(d - 1, 0)).long()
        seen = V[rows, gc]
        rep = proc & ~seen
        V[rows, gc] = seen | proc
        slot = torch.clamp(cnt, max=max_df - 1).long()
        docs[rows, slot] = torch.where(rep, g, docs[rows, slot])
        cnt = torch.where(rep, cnt + 1, cnt)
        k = torch.where(proc, k + 1, k)
        aborted = proc & seen
        ended = scanning & (aborted | (k >= j) | (cnt >= max_df))

        # -- push right subrange first, then left; aborts push nothing
        push = ended & ~aborted
        for x, y, ok in ((i_run + 1, b, i_run + 1 <= b), (a, i_run - 1, a <= i_run - 1)):
            do = push & ok & (sp < cap)
            slot = torch.clamp(sp, max=cap - 1).long()
            sa[rows, slot] = torch.where(do, x, sa[rows, slot])
            sb[rows, slot] = torch.where(do, y, sb[rows, slot])
            sp = torch.where(do, sp + 1, sp)
        scan = scan & ~ended
        it += 1
    return docs, cnt


def ilcp_list(vilcp, table, run_starts, da, lo, hi, *, d: int, max_df: int):
    """Batched ILCP document listing over SA ranges [lo, hi):
    (docs int32[B, max_df] padded -1 in discovery order, cnt int32[B]).
    ``da`` is the DA source: a stored int32[n] array (Sada-I-D) or a CSA
    (Sada-I-L).

    On CUDA tensors this launches the kernel (counted in
    ``ilcp_list.launches``, or ``ilcp_list.csa_launches`` for a CSA
    source); on CPU tensors it runs the plain version.  ``B == 0``,
    ``max_df <= 0`` and ``d <= 0`` have a closed-form empty answer and
    launch nothing."""
    B = lo.shape[0]
    dev = lo.device
    if B == 0 or max_df <= 0 or d <= 0:
        return (torch.full((B, max(max_df, 0)), -1, dtype=IDX, device=dev),
                torch.zeros(B, dtype=IDX, device=dev))
    record("ilcp_list", vilcp, table, run_starts, da, lo, hi)
    if dev.type != "cuda":
        return ilcp_list_plain(vilcp, table, run_starts, da, lo, hi,
                               runs_of(run_starts, lo), runs_of(run_starts, hi - 1),
                               d=d, max_df=max_df)
    for name, t, dims in (("vilcp", vilcp, 1), ("table", table, 2),
                          ("run_starts", run_starts, 1), ("lo", lo, 1), ("hi", hi, 1)):
        _build.check_operand(name, t, dims, dev)
    levels, rho = table.shape
    if vilcp.shape[0] != rho or run_starts.shape[0] != rho + 1 or hi.shape[0] != B:
        raise ValueError("ilcp_list: inconsistent operand shapes")
    smem = 4 * (3 * stack_cap(max_df) + -(-d // 32))
    if smem > _build.MAX_SHARED_BYTES:
        raise ValueError(f"ilcp_list: max_df={max_df} and d={d} need {smem} bytes of "
                         f"shared memory per query, over the card's {_build.MAX_SHARED_BYTES}")
    docs = torch.empty((B, max_df), dtype=IDX, device=dev)
    cnt = torch.empty(B, dtype=IDX, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ops = (vilcp.data_ptr(), table.data_ptr(), run_starts.data_ptr(), lo.data_ptr(),
           hi.data_ptr(), docs.data_ptr(), cnt.data_ptr())
    if isinstance(da, CSA):
        ptrs, ints = check_csa_operands(da, dev)
        err = _build.library().rt_ilcp_list_csa(*ptrs, *ops, *ints, B, levels, rho, d,
                                                max_df, stream)
        _build.check(err, "ilcp_list[csa]")
        ilcp_list.csa_launches += 1
        return docs, cnt
    _build.check_operand("da", da, 1, dev)
    err = _build.library().rt_ilcp_list(
        vilcp.data_ptr(), table.data_ptr(), run_starts.data_ptr(), da.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), docs.data_ptr(), cnt.data_ptr(), B, levels, rho,
        int(da.shape[0]), d, max_df, stream,
    )
    _build.check(err, "ilcp_list")
    ilcp_list.launches += 1
    return docs, cnt


ilcp_list.launches = 0
ilcp_list.csa_launches = 0
