"""PDL — Precomputed Document Lists, listing mode (Section 4; counterpart of
``repro.core.pdl``).

Build (host numpy, offline, as in the reference): suffix-tree topology from
LCP, leaf blocks of at most ``block_size`` suffixes, bottom-up beta-pruning
of internal nodes, sorted document lists Re-Pair-compressed with a shared
grammar.  The top-k mode (frequencies) is not ported yet.

Query: partial head/tail blocks go through brute CSA windows; full blocks
through the Fig-4 climb to the highest stored node that fits in the query,
whose list is decompressed with a bounded grammar stack.  The reference
runs the climb, the expansion and the cover loop as nested per-query
``while_loop``s under ``vmap``.  Here they are one batched state machine
with masks: each query's trajectory, and its ``max_buf`` / ``max_cover``
truncation, are the reference's.  Every masked loop syncs with the host
once per round to test whether any query is still running.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import (
    IDX, TensorDataclass, as_i32, ceil_log2, elias_fano_bits, searchsorted_i32,
)
from repro_torch.core.csa import CSA, csa_doc_of, csa_lookup
from repro_torch.core.listing import _distinct_from_window
from repro_torch.core.sufftree import lcp_interval_tree
from repro_torch.core.suffix import SuffixData
from repro_torch.grammar.repair import repair_compress_lists


@dataclasses.dataclass(frozen=True)
class PDLIndex(TensorDataclass):
    # --- leaf tiling ---------------------------------------------------
    leaf_starts: torch.Tensor     # int32[L + 1] SA offsets; leaf_starts[L] = n
    # --- sparse tree (nodes: 0..L-1 leaves, L..L+I-1 internal) ----------
    is_first_child: torch.Tensor  # bool[L + I]
    parent_of: torch.Tensor       # int32[L + I]: internal idx for first children, else -1
    next_leaf: torch.Tensor       # int32[max(I,1)]: leaf idx after internal subtree
    # --- stored (reduced) document lists --------------------------------
    set_off: torch.Tensor         # int32[L + I + 1] into A
    A: torch.Tensor               # int32: terminal (< d) or nonterminal (> d)
    rule_left: torch.Tensor       # int32[max(R,1)]
    rule_right: torch.Tensor      # int32[max(R,1)]
    doc_base: torch.Tensor        # int32[L + I + 1] prefix sum of |D_v|
    # --- static metadata --------------------------------------------------
    n: int
    d: int
    L: int
    I: int  # noqa: E741 (the paper's name)
    block_size: int
    beta: float | None
    nrules: int
    max_set_len: int
    max_rule_depth: int
    total_docs_stored: int

    def modeled_bits(self) -> int:
        """Paper Section 4.1 accounting: A, G, B_A, B_G, B_L, B_F, F, N."""
        L, I, n, d = self.L, self.I, self.n, self.d  # noqa: E741
        nR = self.nrules
        a_bits = int(self.A.shape[0]) * ceil_log2(d + nR + 1)
        g_bits = 2 * nR * ceil_log2(d + nR + 1)
        ba_bits = int(self.A.shape[0]) + 2 * (L + I)
        bl_bits = elias_fano_bits(L, max(n, 1))
        bf_bits = (L + I) + I * ceil_log2(max(2, I)) + I * ceil_log2(max(2, L))
        return a_bits + g_bits + ba_bits + bl_bits + bf_bits


# ===========================================================================
# Construction (host)
# ===========================================================================


def _node_set(da: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return np.unique(da[lo:hi]).astype(np.int64)


def build_pdl(
    data: SuffixData,
    block_size: int = 256,
    beta: float | None = 16.0,
    mode: str = "list",
    repair_kwargs: dict | None = None,
) -> PDLIndex:
    if mode != "list":
        raise ValueError(f"PDL mode {mode!r} is not ported (only 'list')")
    da = data.da.cpu().numpy()
    n, d = data.n, data.d
    b = block_size

    tree = lcp_interval_tree(data.lcp.cpu().numpy())
    kids_of = tree.children_lists()
    sizes = tree.hi - tree.lo

    # root = the interval covering [0, n); tiny collections may lack
    # internal nodes entirely
    roots = [k for k in range(tree.size) if tree.parent[k] < 0]

    leaf_bounds: list = []
    internal_children: list = []
    internal_next_leaf: list = []
    node_is_leaf: list[bool] = []
    set_store: list[np.ndarray] = []

    def new_leaf(lo: int, hi: int) -> int:
        nid = len(set_store)
        set_store.append(_node_set(da, lo, hi))
        node_is_leaf.append(True)
        leaf_bounds.append((lo, hi))
        return nid

    # iterative post-order over big (> b) internal nodes
    # frame: [tree_node, unit list under construction, cursor pos, child idx]
    def process(root_k: int) -> list[int]:
        stack = [[root_k, [], int(tree.lo[root_k]), 0, None]]
        result: dict[int, list[int]] = {}
        while stack:
            frame = stack[-1]
            k, units, cursor, ci, pending = frame
            children = [c for c in kids_of[k] if sizes[c] >= 2]
            # absorb a finished child cover
            if pending is not None:
                units.extend(result.pop(pending))
                frame[4] = None
            advanced = False
            while ci < len(children):
                c = children[ci]
                clo, chi = int(tree.lo[c]), int(tree.hi[c])
                # leading gap positions: single-suffix leaves
                while cursor < clo:
                    units.append(new_leaf(cursor, cursor + 1))
                    cursor += 1
                if chi - clo <= b:
                    units.append(new_leaf(clo, chi))
                    cursor = chi
                    ci += 1
                else:
                    # recurse
                    frame[1], frame[2], frame[3] = units, chi, ci + 1
                    frame[4] = c
                    stack.append([c, [], clo, 0, None])
                    advanced = True
                    break
                frame[1], frame[2], frame[3] = units, cursor, ci
            if advanced:
                continue
            # trailing gap positions
            hi_k = int(tree.hi[k])
            while cursor < hi_k:
                units.append(new_leaf(cursor, cursor + 1))
                cursor += 1
            # finalize node k
            stack.pop()
            docs = _node_set(da, int(tree.lo[k]), hi_k)
            child_total = sum(len(set_store[u]) for u in units)
            if beta is None or child_total > beta * len(docs):
                nid = len(set_store)
                set_store.append(docs)
                node_is_leaf.append(False)
                internal_children.append(list(units))
                internal_next_leaf.append(len(leaf_bounds))
                cover = [nid]
            else:
                cover = list(units)
            if stack:
                result[k] = cover
            else:
                return cover
        return []

    if tree.size == 0 or n <= b:
        new_leaf(0, n)  # whole collection is one leaf block
    else:
        root_k = max(roots, key=lambda k: int(sizes[k]))
        if int(tree.lo[root_k]) != 0 or int(tree.hi[root_k]) != n:
            raise AssertionError("lcp-interval tree has no [0, n) root")
        process(root_k)

    # renumber: leaves first (creation order == left-to-right), then
    # internal nodes (creation order == post-order)
    leaf_old = [i for i in range(len(set_store)) if node_is_leaf[i]]
    internal_old = [i for i in range(len(set_store)) if not node_is_leaf[i]]
    remap = {old: new for new, old in enumerate(leaf_old)}
    L = len(leaf_old)
    for j, old in enumerate(internal_old):
        remap[old] = L + j
    I = len(internal_old)  # noqa: E741

    lists = [None] * (L + I)
    for old, new in remap.items():
        lists[new] = set_store[old]

    leaf_bounds_sorted = sorted(leaf_bounds)
    leaf_starts = np.asarray([lo for lo, _ in leaf_bounds_sorted] + [n], dtype=np.int32)
    ends = [hi for _, hi in leaf_bounds_sorted]
    if not (leaf_starts[0] == 0 and ends[-1] == n
            and all(ends[i] == leaf_starts[i + 1] for i in range(L))):
        raise AssertionError("PDL leaves must tile [0, n)")

    is_first_child = np.zeros(L + I, dtype=bool)
    parent_of = np.full(L + I, -1, dtype=np.int32)
    next_leaf = np.zeros(max(I, 1), dtype=np.int32)
    for j in range(I):
        # creation order of internal nodes matches internal_children order
        next_leaf[j] = internal_next_leaf[j]
        first = remap[internal_children[j][0]]
        is_first_child[first] = True
        parent_of[first] = j

    # grammar compression of all lists (shared grammar)
    g, segments = repair_compress_lists(lists, alphabet=d, **(repair_kwargs or {}))
    set_off = np.zeros(L + I + 1, dtype=np.int32)
    for i, seg in enumerate(segments):
        set_off[i + 1] = set_off[i] + len(seg)
    A = np.concatenate(segments).astype(np.int32) if L + I else np.zeros(0, np.int32)
    R = g.nrules
    rule_left = g.rules[:, 0].astype(np.int32) if R else np.zeros(1, np.int32)
    rule_right = g.rules[:, 1].astype(np.int32) if R else np.zeros(1, np.int32)

    # rule depth (bounds the query-time expansion stack)
    depth = np.zeros(max(R, 1), dtype=np.int64)
    for r in range(R):
        left, right = g.rules[r]
        dl = 1 if left <= d else 1 + depth[left - d - 1]
        dr = 1 if right <= d else 1 + depth[right - d - 1]
        depth[r] = max(dl, dr)
    max_rule_depth = int(depth.max()) if R else 1

    set_sizes = np.asarray([len(x) for x in lists], dtype=np.int64)
    doc_base = np.concatenate([[0], np.cumsum(set_sizes)]).astype(np.int32)

    dev = data.device
    return PDLIndex(
        leaf_starts=as_i32(leaf_starts, dev),
        is_first_child=torch.as_tensor(is_first_child, device=dev),
        parent_of=as_i32(parent_of, dev),
        next_leaf=as_i32(next_leaf, dev),
        set_off=as_i32(set_off, dev),
        A=as_i32(A, dev),
        rule_left=as_i32(rule_left, dev),
        rule_right=as_i32(rule_right, dev),
        doc_base=as_i32(doc_base, dev),
        n=n,
        d=d,
        L=L,
        I=I,
        block_size=block_size,
        beta=beta,
        nrules=R,
        max_set_len=int(set_sizes.max()) if len(set_sizes) else 0,
        max_rule_depth=max_rule_depth,
        total_docs_stored=int(set_sizes.sum()),
    )


# ===========================================================================
# Query (batched state machines)
# ===========================================================================


def _brute_window_into(csa: CSA, lo, hi, buf, base, cap: int, window: int):
    """CSA-locate the partial blocks [lo, hi) (hi - lo <= window) into the
    rows of ``buf`` after ``base``.  Slot ``cap`` of ``buf`` takes every
    write the reference drops."""
    idx = lo[:, None] + torch.arange(window, dtype=IDX, device=lo.device)[None, :]
    valid = idx < hi[:, None]
    docs = csa_doc_of(csa, csa_lookup(csa, torch.clamp(idx, max=csa.n - 1)))
    offs = torch.cumsum(valid.to(IDX), 1, dtype=IDX) - 1
    widx = torch.clamp(torch.where(valid, base[:, None] + offs, cap), max=cap)
    buf.scatter_(1, widx.long(), docs)
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


def _expand_into(index: PDLIndex, nd, buf, base, cap: int, active):
    """Decompress node ``nd``'s list into each active row of ``buf`` from
    ``base`` on, emitting at most cap - base entries.  Returns the new
    base."""
    d = index.d
    B = nd.shape[0]
    dev = nd.device
    rows = torch.arange(B, device=dev)
    ndc = torch.clamp(nd, 0, index.L + index.I - 1)
    ptr = index.set_off[ndc]
    end = index.set_off[ndc + 1]
    stack_size = 2 * index.max_rule_depth + 4
    lenA = int(index.A.shape[0])
    nrule = int(index.rule_left.shape[0])
    iter_cap = 4 * index.max_set_len + 16
    stack = torch.zeros((B, stack_size), dtype=IDX, device=dev)
    sp = torch.zeros(B, dtype=IDX, device=dev)
    cnt = torch.zeros(B, dtype=IDX, device=dev)
    run = active.clone()
    for _ in range(iter_cap):
        run = run & ((ptr < end) | (sp > 0)) & (base + cnt < cap)
        if not bool(run.any()):
            break
        from_stack = sp > 0
        sym = torch.where(
            from_stack,
            stack[rows, torch.clamp(sp - 1, min=0).long()],
            index.A[torch.clamp(ptr, max=lenA - 1)],
        )
        sp = torch.where(run & from_stack, sp - 1, sp)
        ptr = torch.where(run & ~from_stack, ptr + 1, ptr)
        is_term = sym < d
        emit = run & is_term
        buf[rows, torch.where(emit, base + cnt, cap).long()] = sym
        cnt = torch.where(emit, cnt + 1, cnt)
        # push rule children: right then left (left expands first)
        push = run & ~is_term
        ridx = torch.clamp(sym - d - 1, 0, nrule - 1)
        for child in (index.rule_right[ridx], index.rule_left[ridx]):
            slot = torch.clamp(sp, max=stack_size - 1).long()
            stack[rows, slot] = torch.where(push, child, stack[rows, slot])
            sp = torch.where(push, sp + 1, sp)
    return base + cnt


def _pdl_gather(index: PDLIndex, csa: CSA, lo, hi, max_buf: int, max_cover: int):
    """Fill a buffer with the doc ids covering SA[lo, hi): partial blocks
    via CSA, full blocks via climb + expansion.  Returns (buf[B, max_buf],
    count[B]); a count past ``max_buf`` means the buffer truncated."""
    B = lo.shape[0]
    L = index.L
    leaf_starts = index.leaf_starts
    cap = max_buf
    buf = torch.zeros((B, max_buf + 1), dtype=IDX, device=lo.device)

    # full leaves: first leaf starting >= lo .. last leaf ending <= hi
    ln = searchsorted_i32(leaf_starts[:L].contiguous(), lo)
    rn = searchsorted_i32(leaf_starts[1:].contiguous(), hi, right=True) - 1

    head_hi = torch.minimum(hi, leaf_starts[torch.clamp(ln, max=L)])
    base = torch.zeros(B, dtype=IDX, device=lo.device)
    base = _brute_window_into(csa, lo, head_hi, buf, base, cap, index.block_size)
    tail_lo = torch.maximum(
        leaf_starts[torch.clamp(torch.maximum(rn + 1, ln), max=L)], head_hi
    )
    base = _brute_window_into(csa, tail_lo, hi, buf, base, cap, index.block_size)

    i = ln
    active = i <= rn
    for _ in range(max_cover):
        if not bool(active.any()):
            break
        node, nxt = _climb(index, i, rn, active)
        base = _expand_into(index, node, buf, base, cap, active)
        i = torch.where(active, nxt, i)
        active = active & (i <= rn)
    return buf[:, :max_buf], base


def pdl_list_docs_batch(index: PDLIndex, csa: CSA, lo, hi, max_df: int,
                        max_buf: int = 4096, max_cover: int = 1024):
    """PDL listing over a range batch (masked-query contract of
    repro_torch.core.listing): (docs int32[B, max_df] ascending, -1
    padded, count[B])."""
    bd, cnt = _pdl_gather(index, csa, lo, hi, max_buf, max_cover)
    valid = torch.arange(max_buf, device=lo.device)[None, :] < cnt[:, None]
    docs, count, _ = _distinct_from_window(bd, valid, max_df)
    return docs, count
