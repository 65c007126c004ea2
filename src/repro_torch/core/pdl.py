"""PDL — Precomputed Document Lists (Section 4; counterpart of
``repro.core.pdl``).

Build (host numpy, offline, as in the reference): suffix-tree topology from
LCP, leaf blocks of at most ``block_size`` suffixes, bottom-up beta-pruning
of internal nodes (``beta=None`` keeps every one), document lists
Re-Pair-compressed with a shared grammar.  Listing mode stores each list
sorted by id; top-k mode sorts it by (tf desc, id asc) and stores the
frequencies as runs over the concatenated lists (Section 4.2).

Query: partial head/tail blocks go through brute CSA windows (frequency 1
per entry); full blocks through the Fig-4 climb to the highest stored node
that fits in the query, whose list is decompressed with a bounded grammar
stack, each entry with its stored frequency.  The reference
runs the climb, the expansion and the cover loop as nested per-query
``while_loop``s under ``vmap``.  Here the gather is one kernel launch per
batch (``repro_torch.kernels.pdl_gather``), with no host sync; each
query's trajectory, and its ``max_buf`` / ``max_cover`` truncation, are the
reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import (
    BIG, IDX, TensorDataclass, as_i32, batch_of_one, ceil_log2, elias_fano_bits,
    lexsort_rows,
)
from repro_torch.core.csa import CSA
from repro_torch.core.listing import _distinct_from_window
from repro_torch.core.sufftree import lcp_interval_tree
from repro_torch.core.suffix import SuffixData
from repro_torch.grammar.repair import repair_compress_lists
from repro_torch.kernels.pdl_gather import pdl_gather


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
    # --- frequencies (top-k mode; [0] and [1] in listing mode) ---------
    freq_vals: torch.Tensor       # int32[K] run values
    freq_gcum: torch.Tensor       # int32[K] strictly increasing global cum counts
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
    has_freqs: bool
    total_docs_stored: int

    def modeled_bits(self) -> int:
        """Paper Section 4.1 accounting: A, G, B_A, B_G, B_L, B_F, F, N
        (+ the delta-coded frequency runs of the top-k mode)."""
        L, I, n, d = self.L, self.I, self.n, self.d  # noqa: E741
        nR = self.nrules
        a_bits = int(self.A.shape[0]) * ceil_log2(d + nR + 1)
        g_bits = 2 * nR * ceil_log2(d + nR + 1)
        ba_bits = int(self.A.shape[0]) + 2 * (L + I)
        bl_bits = elias_fano_bits(L, max(n, 1))
        bf_bits = (L + I) + I * ceil_log2(max(2, I)) + I * ceil_log2(max(2, L))
        freq_bits = 0
        if self.has_freqs:
            fv = self.freq_vals.cpu().numpy().astype(np.int64)
            lens = np.diff(self.freq_gcum.cpu().numpy().astype(np.int64), prepend=0)
            freq_bits = int(_delta_bits(fv + 1).sum() + _delta_bits(np.maximum(lens, 1)).sum())
        return a_bits + g_bits + ba_bits + bl_bits + bf_bits + freq_bits


def _delta_bits(v: np.ndarray) -> np.ndarray:
    """``delta_code_len`` of every value of an array of positive integers
    (floor(lg x) is the binary exponent of x, exact below 2^53)."""
    n = np.frexp(v.astype(np.float64))[1] - 1
    return 2 * (np.frexp((n + 1).astype(np.float64))[1] - 1) + 1 + n


# ===========================================================================
# Construction (host)
# ===========================================================================


def _node_set(da: np.ndarray, lo: int, hi: int, topk: bool):
    """Distinct documents of DA[lo:hi] and their frequencies: by id, or by
    (tf desc, id asc) in top-k mode."""
    docs, counts = np.unique(da[lo:hi], return_counts=True)
    if topk:
        order = np.lexsort((docs, -counts))
        docs, counts = docs[order], counts[order]
    return docs.astype(np.int64), counts.astype(np.int64)


def build_pdl(
    data: SuffixData,
    block_size: int = 256,
    beta: float | None = 16.0,
    mode: str = "list",
    repair_kwargs: dict | None = None,
) -> PDLIndex:
    if mode not in ("list", "topk"):
        raise ValueError(f"PDL mode must be 'list' or 'topk', not {mode!r}")
    topk = mode == "topk"
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
    freq_store: list[np.ndarray] = []

    def new_leaf(lo: int, hi: int) -> int:
        nid = len(set_store)
        docs, freqs = _node_set(da, lo, hi, topk)
        set_store.append(docs)
        freq_store.append(freqs)
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
            docs, freqs = _node_set(da, int(tree.lo[k]), hi_k, topk)
            child_total = sum(len(set_store[u]) for u in units)
            if beta is None or child_total > beta * len(docs):
                nid = len(set_store)
                set_store.append(docs)
                freq_store.append(freqs)
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
    freqs_l = [None] * (L + I)
    for old, new in remap.items():
        lists[new] = set_store[old]
        freqs_l[new] = freq_store[old]

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

    # frequency runs over the concatenated lists: a run ends where the next
    # frequency differs or a list ends
    freq_vals, freq_gcum = [0], [1]
    if topk and set_sizes.sum():
        flat = np.concatenate([f for f in freqs_l if len(f)])
        ends = np.zeros(len(flat), bool)
        ends[:-1] = flat[1:] != flat[:-1]
        ends[doc_base[1:][set_sizes > 0] - 1] = True
        freq_vals = flat[ends]
        freq_gcum = np.flatnonzero(ends) + 1

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
        freq_vals=as_i32(freq_vals, dev),
        freq_gcum=as_i32(freq_gcum, dev),
        n=n,
        d=d,
        L=L,
        I=I,
        block_size=block_size,
        beta=beta,
        nrules=R,
        max_set_len=int(set_sizes.max()) if len(set_sizes) else 0,
        max_rule_depth=max_rule_depth,
        has_freqs=topk,
        total_docs_stored=int(set_sizes.sum()),
    )


# ===========================================================================
# Query (through the gather kernel's wrapper)
# ===========================================================================


def pdl_list_docs_batch(index: PDLIndex, csa: CSA, lo, hi, max_df: int,
                        max_buf: int = 4096, max_cover: int = 1024):
    """PDL listing over a range batch (masked-query contract of
    repro_torch.core.listing): (docs int32[B, max_df] ascending, -1
    padded, count[B])."""
    bd, _, cnt = pdl_gather(index, csa, lo.contiguous(), hi.contiguous(), max_buf, max_cover)
    valid = torch.arange(max_buf, device=lo.device)[None, :] < cnt[:, None]
    docs, count, _ = _distinct_from_window(bd, valid, max_df)
    return docs, count


def pdl_doc_freqs_batch(index: PDLIndex, csa: CSA, lo, hi, max_buf: int = 4096,
                        max_cover: int = 1024):
    """Per-range (document, tf) aggregation, the primitive behind top-k and
    tf-idf: the gathered entries merged by document with their frequencies
    summed.  Returns (docs int32[B, max_buf] ascending, padded with
    INT32_MAX; tf int32[B, max_buf]; ndocs int32[B])."""
    bd, bf, cnt = pdl_gather(index, csa, lo.contiguous(), hi.contiguous(), max_buf, max_cover)
    B = lo.shape[0]
    dev = lo.device
    pos = torch.arange(max_buf, dtype=IDX, device=dev)
    valid = pos[None, :] < cnt[:, None]
    s_docs, order = torch.sort(torch.where(valid, bd, BIG), dim=1, stable=True)
    s_freqs = torch.gather(torch.where(valid, bf, 0), 1, order)
    new_doc = torch.ones_like(valid)
    new_doc[:, 1:] = s_docs[:, 1:] != s_docs[:, :-1]
    is_doc = s_docs < BIG
    new_doc &= is_doc
    cums = torch.zeros((B, max_buf + 1), dtype=IDX, device=dev)
    cums[:, 1:] = torch.cumsum(s_freqs, 1, dtype=IDX)
    seg_id = torch.cumsum(new_doc.to(IDX), 1, dtype=IDX) - 1
    nseg = new_doc.sum(1, dtype=IDX)
    # segment starts; writes the reference drops land in the last column
    starts = torch.zeros((B, max_buf + 2), dtype=IDX, device=dev)
    starts.scatter_(1, torch.where(new_doc, seg_id, max_buf + 1).long(),
                    pos.expand(B, max_buf))
    col = torch.arange(max_buf + 1, dtype=IDX, device=dev)[None, :]
    starts = torch.where(col < nseg[:, None], starts[:, : max_buf + 1],
                         is_doc.sum(1, dtype=IDX)[:, None]).long()
    tf = torch.gather(cums, 1, starts[:, 1:]) - torch.gather(cums, 1, starts[:, :-1])
    seg_docs = torch.gather(s_docs, 1, torch.clamp(starts[:, :max_buf], max=max_buf - 1))
    seg_valid = pos[None, :] < nseg[:, None]
    return (torch.where(seg_valid, seg_docs, BIG).to(IDX),
            torch.where(seg_valid, tf, 0).to(IDX), nseg)


def pdl_topk_batch(index: PDLIndex, csa: CSA, lo, hi, k: int, max_buf: int = 4096,
                   max_cover: int = 1024):
    """Top-k documents of each range by (tf desc, id asc), k <= max_buf:
    (docs int32[B, k] padded -1, tf int32[B, k])."""
    seg_docs, tf, nseg = pdl_doc_freqs_batch(index, csa, lo, hi, max_buf, max_cover)
    seg_valid = torch.arange(max_buf, device=lo.device)[None, :] < nseg[:, None]
    negtf = torch.where(seg_valid, -tf, BIG)
    dkey = torch.where(seg_valid, seg_docs, BIG)
    top = lexsort_rows(negtf, dkey)[:, :k]
    ok = torch.arange(k, device=lo.device)[None, :] < torch.clamp(nseg, max=k)[:, None]
    return (torch.where(ok, torch.gather(dkey, 1, top), -1).to(IDX),
            torch.where(ok, -torch.gather(negtf, 1, top), 0).to(IDX))


# Single-query forms (the reference's per-query engine): the batch
# functions over a batch of one, one gather launch each on the card.


def pdl_list_docs(index: PDLIndex, csa: CSA, lo, hi, max_df: int, max_buf: int = 4096,
                  max_cover: int = 1024):
    """Distinct documents of DA[lo, hi) for one range: (docs int32[max_df]
    ascending, -1 padded; count)."""
    dev = csa.device
    docs, cnt = pdl_list_docs_batch(index, csa, batch_of_one(lo, dev), batch_of_one(hi, dev),
                                    max_df, max_buf, max_cover)
    return docs[0], cnt[0]


def pdl_doc_freqs(index: PDLIndex, csa: CSA, lo, hi, max_buf: int = 4096,
                  max_cover: int = 1024):
    """(document, tf) pairs of one range: (docs int32[max_buf] ascending,
    padded with INT32_MAX; tf int32[max_buf]; ndocs)."""
    dev = csa.device
    docs, tf, nseg = pdl_doc_freqs_batch(index, csa, batch_of_one(lo, dev),
                                         batch_of_one(hi, dev), max_buf, max_cover)
    return docs[0], tf[0], nseg[0]


def pdl_topk(index: PDLIndex, csa: CSA, lo, hi, k: int, max_buf: int = 4096,
             max_cover: int = 1024):
    """Top-k documents of one range by (tf desc, id asc): (docs int32[k]
    padded -1, tf int32[k])."""
    dev = csa.device
    docs, tf = pdl_topk_batch(index, csa, batch_of_one(lo, dev), batch_of_one(hi, dev),
                              k, max_buf, max_cover)
    return docs[0], tf[0]
