"""PDL gather: the Hopper kernel, its plain version and the wrapper.

The gather fills, per query, a buffer with the (doc id, tf) entries that
cover SA[lo, hi): the partial head and tail blocks by CSA locate (tf 1),
the full blocks by the Fig-4 climb to the highest stored node that fits in
the range and the grammar expansion of its list (each entry with its stored
frequency in top-k mode).  It is the port's own kernel: the reference's
``repro.core.pdl._pdl_gather`` is XLA (nested ``while_loop``s under
``vmap``), with no Pallas counterpart.

The kernel (``csrc/retrieval_kernels.cu``, ``pdl_gather_kernel``; core
``rt::pdl_gather_block`` and its pieces in ``retrieval_core.cuh``) serves
one query per block of ``GATHER_THREADS`` threads, which climb a chunk of
the cover's leaves at once, give the chunk's nodes their offsets by a scan
of their list sizes, and expand the nodes of up to ``PDL_ROUNDS`` chunks
side by side.  The plain version
is the reference's serial state machine batched with masks; it syncs with
the host once per round of each masked loop.  Both give each query's
entries in the reference's order with its ``max_buf`` / ``max_cover``
truncation, so their integers are identical.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.common import IDX, searchsorted_i32
from repro_torch.core.csa import CSA, csa_doc_of, csa_lookup
from repro_torch.kernels import _build
from repro_torch.kernels._record import record
from repro_torch.kernels.csa_view import csa_operands

if TYPE_CHECKING:
    from repro_torch.core.pdl import PDLIndex


#: threads of the kernel's block, and leaves of one chunk of the cover
#: (``kGatherThreads`` in ``csrc/retrieval_kernels.cu``)
GATHER_THREADS = 256
#: chunks whose members one expansion phase takes (``rt::kPdlRounds``)
PDL_ROUNDS = 4


def stack_size(index: PDLIndex) -> int:
    """Entries of the grammar expansion stack (the reference's bound)."""
    return 2 * index.max_rule_depth + 4


def iter_cap(index: PDLIndex) -> int:
    """Steps of one node's expansion (the reference's bound)."""
    return 4 * index.max_set_len + 16


def shared_bytes(index: PDLIndex) -> int:
    """The kernel block's shared memory (``rt::pdl_scratch_ints``): per
    thread a grammar stack, ``PDL_ROUNDS`` held members (node and slot) and
    one climb's next leaf, then the scan's warp sums and the chain's two
    words."""
    return 4 * (GATHER_THREADS * (2 * PDL_ROUNDS + 1 + stack_size(index))
                + GATHER_THREADS // 32 + 3)


# ---------------------------------------------------------------------------
# Plain version (batched state machines with masks)
# ---------------------------------------------------------------------------


def _brute_window_into(csa: CSA, lo, hi, buf, fbuf, base, cap: int, window: int):
    """CSA-locate the partial blocks [lo, hi) (hi - lo <= window) into the
    rows of ``buf`` after ``base``, each with frequency 1 in ``fbuf``.
    Slot ``cap`` takes every write the reference drops."""
    idx = lo[:, None] + torch.arange(window, dtype=IDX, device=lo.device)[None, :]
    valid = idx < hi[:, None]
    docs = csa_doc_of(csa, csa_lookup(csa, torch.clamp(idx, max=csa.n - 1)))
    offs = torch.cumsum(valid.to(IDX), 1, dtype=IDX) - 1
    widx = torch.clamp(torch.where(valid, base[:, None] + offs, cap), max=cap).long()
    buf.scatter_(1, widx, docs)
    fbuf.scatter_(1, widx, 1)
    return base + valid.sum(1, dtype=IDX)


def _climb(index: PDLIndex, leaf_i, rn, active):
    """Fig 4 parent(): for each active query, the highest stored ancestor
    of leaf ``leaf_i`` whose subtree fits in leaves [.., rn].  Returns
    (node id, next leaf index)."""
    node = leaf_i.clone()
    nxt = leaf_i + 1
    go = active.clone()
    top = index.L + index.I - 1
    while bool(go.any()):
        nc = torch.clamp(node, max=top)
        par = index.parent_of[nc]
        nl = index.next_leaf[torch.clamp(par, 0, max(index.I - 1, 0))]
        ok = go & index.is_first_child[nc] & (par >= 0) & (nl - 1 <= rn)
        node = torch.where(ok, index.L + par, node)
        nxt = torch.where(ok, nl, nxt)
        go = ok
    return node, nxt


def _expand_into(index: PDLIndex, nd, buf, fbuf, base, cap: int, active):
    """Decompress node ``nd``'s list into each active row of ``buf`` from
    ``base`` on, emitting at most cap - base entries, with each entry's
    stored frequency in ``fbuf`` (1 in listing mode).  A full stack
    overwrites its top slot while sp still grows, and a pop past it reads
    the top slot (the reference's clamped gathers).  Returns the new
    base."""
    d = index.d
    B = nd.shape[0]
    dev = nd.device
    rows = torch.arange(B, device=dev)
    ndc = torch.clamp(nd, 0, index.L + index.I - 1)
    ptr = index.set_off[ndc]
    end = index.set_off[ndc + 1]
    gbase = index.doc_base[ndc]
    size = stack_size(index)
    lenA = int(index.A.shape[0])
    nrule = int(index.rule_left.shape[0])
    nruns = int(index.freq_vals.shape[0])
    stack = torch.zeros((B, size), dtype=IDX, device=dev)
    sp = torch.zeros(B, dtype=IDX, device=dev)
    cnt = torch.zeros(B, dtype=IDX, device=dev)
    run = active.clone()
    for _ in range(iter_cap(index)):
        run = run & ((ptr < end) | (sp > 0)) & (base + cnt < cap)
        if not bool(run.any()):
            break
        from_stack = sp > 0
        sym = torch.where(
            from_stack,
            stack[rows, torch.clamp(sp - 1, 0, size - 1).long()],
            index.A[torch.clamp(ptr, max=lenA - 1)],
        )
        sp = torch.where(run & from_stack, sp - 1, sp)
        ptr = torch.where(run & ~from_stack, ptr + 1, ptr)
        is_term = sym < d
        emit = run & is_term
        widx = torch.where(emit, base + cnt, cap).long()
        buf[rows, widx] = sym
        if index.has_freqs:
            run_of = searchsorted_i32(index.freq_gcum, gbase + cnt, right=True)
            fbuf[rows, widx] = index.freq_vals[torch.clamp(run_of, max=nruns - 1)]
        else:
            fbuf[rows, widx] = 1
        cnt = torch.where(emit, cnt + 1, cnt)
        # push rule children: right then left (left expands first)
        push = run & ~is_term
        ridx = torch.clamp(sym - d - 1, 0, nrule - 1)
        for child in (index.rule_right[ridx], index.rule_left[ridx]):
            slot = torch.clamp(sp, max=size - 1).long()
            stack[rows, slot] = torch.where(push, child, stack[rows, slot])
            sp = torch.where(push, sp + 1, sp)
    return base + cnt


def pdl_gather_plain(index: PDLIndex, csa: CSA, lo, hi, max_buf: int, max_cover: int):
    """Plain PyTorch version of the kernel: (docs int32[B, max_buf],
    tf int32[B, max_buf], count int32[B]), zero past each row's entries;
    a count past ``max_buf`` means the buffer truncated."""
    B = lo.shape[0]
    L = index.L
    leaf_starts = index.leaf_starts
    cap = max_buf
    buf = torch.zeros((B, max_buf + 1), dtype=IDX, device=lo.device)
    fbuf = torch.zeros((B, max_buf + 1), dtype=IDX, device=lo.device)

    # full leaves: first leaf starting >= lo .. last leaf ending <= hi
    ln = searchsorted_i32(leaf_starts[:L].contiguous(), lo)
    rn = searchsorted_i32(leaf_starts[1:].contiguous(), hi, right=True) - 1

    head_hi = torch.minimum(hi, leaf_starts[torch.clamp(ln, max=L)])
    base = torch.zeros(B, dtype=IDX, device=lo.device)
    base = _brute_window_into(csa, lo, head_hi, buf, fbuf, base, cap, index.block_size)
    tail_lo = torch.maximum(
        leaf_starts[torch.clamp(torch.maximum(rn + 1, ln), max=L)], head_hi
    )
    base = _brute_window_into(csa, tail_lo, hi, buf, fbuf, base, cap, index.block_size)

    i = ln
    active = i <= rn
    for _ in range(max_cover):
        if not bool(active.any()):
            break
        node, nxt = _climb(index, i, rn, active)
        base = _expand_into(index, node, buf, fbuf, base, cap, active)
        i = torch.where(active, nxt, i)
        active = active & (i <= rn)
    return buf[:, :max_buf], fbuf[:, :max_buf], base


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def kernel_operands(index: PDLIndex, csa: CSA):
    """The launcher's index operands in its order (``rt::CsaView`` then
    ``rt::PdlView``): (tensors, ints).  Also the order of the core's host
    build in the tests."""
    tensors, ints = csa_operands(csa)
    tensors += [
        ("leaf_starts", index.leaf_starts, 1), ("is_first_child", index.is_first_child, 1),
        ("parent_of", index.parent_of, 1), ("next_leaf", index.next_leaf, 1),
        ("set_off", index.set_off, 1), ("A", index.A, 1), ("rule_left", index.rule_left, 1),
        ("rule_right", index.rule_right, 1), ("doc_base", index.doc_base, 1),
        ("freq_vals", index.freq_vals, 1), ("freq_gcum", index.freq_gcum, 1),
    ]
    ints += [
        index.L, index.I, index.d, int(index.A.shape[0]), int(index.rule_left.shape[0]),
        int(index.freq_vals.shape[0]), index.block_size, iter_cap(index), stack_size(index),
        int(index.has_freqs),
    ]
    return tensors, ints


def pdl_gather(index: PDLIndex, csa: CSA, lo, hi, max_buf: int, max_cover: int):
    """The (doc id, tf) entries covering each SA range [lo, hi) (int32[B]
    each): (docs int32[B, max_buf], tf int32[B, max_buf], count int32[B]),
    zero past each row's entries; a count past ``max_buf`` means the buffer
    truncated.

    On CUDA tensors this launches the kernel (counted in
    ``pdl_gather.launches``); on CPU tensors it runs the plain version.
    ``B == 0`` has a closed-form empty answer and launches nothing."""
    if max_buf < 0 or max_cover < 0:
        raise ValueError(f"pdl_gather: max_buf={max_buf} and max_cover={max_cover} "
                         "must be >= 0")
    B = lo.shape[0]
    dev = lo.device
    if B == 0:
        empty = torch.zeros((0, max_buf), dtype=IDX, device=dev)
        return empty, empty.clone(), torch.zeros(0, dtype=IDX, device=dev)
    record("pdl_gather", index, csa, lo, hi)
    if dev.type != "cuda":
        return pdl_gather_plain(index, csa, lo, hi, max_buf, max_cover)
    tensors, ints = kernel_operands(index, csa)
    for name, t, dims in tensors:
        _build.check_operand(name, t, dims, dev,
                             dtypes=(torch.bool,) if name == "is_first_child" else (torch.int32,))
    _build.check_operand("lo", lo, 1, dev)
    _build.check_operand("hi", hi, 1, dev)
    if hi.shape[0] != B:
        raise ValueError("pdl_gather: lo and hi differ in length")
    smem = shared_bytes(index)
    if smem > _build.MAX_SHARED_BYTES:
        raise ValueError(f"pdl_gather: max_rule_depth={index.max_rule_depth} needs grammar "
                         f"stacks of {smem} bytes for {GATHER_THREADS} threads, over the "
                         f"card's {_build.MAX_SHARED_BYTES}")
    docs = torch.empty((B, max_buf), dtype=IDX, device=dev)
    tf = torch.empty((B, max_buf), dtype=IDX, device=dev)
    count = torch.empty(B, dtype=IDX, device=dev)
    err = _build.library().rt_pdl_gather(
        *(t.data_ptr() for _, t, _ in tensors), lo.data_ptr(), hi.data_ptr(),
        docs.data_ptr(), tf.data_ptr(), count.data_ptr(), *ints, B, max_buf, max_cover,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "pdl_gather")
    pdl_gather.launches += 1
    return docs, tf, count


pdl_gather.launches = 0
