"""Suffix-tree topology from the LCP array (lcp-interval tree).

PDL (Section 4) and Sadakane's counting structure (Section 5) both need the
*shape* of the suffix tree, not its edges: every internal node corresponds
to an lcp-interval [lo, hi) of the suffix array (Abouelhoda et al. 2004).
This module enumerates those intervals and their nesting with the classic
stack sweep over LCP — O(n), host-side, build-time only.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LcpIntervalTree:
    """Internal suffix-tree nodes as lcp-intervals.

    depth[k], lo[k], hi[k]  — string depth and SA range [lo, hi) of node k.
    parent[k]               — index of the smallest enclosing interval (-1 root)
    Nodes are emitted in an order where children precede parents (post-order
    of the sweep); ``order_topdown`` gives parent-before-child order.
    Every node has hi - lo >= 2; single suffixes are implicit leaves.
    """

    depth: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    parent: np.ndarray

    @property
    def size(self) -> int:
        return len(self.depth)

    def order_topdown(self) -> np.ndarray:
        return np.lexsort((-(self.hi - self.lo), self.lo))

    def children_lists(self) -> list[list[int]]:
        kids: list[list[int]] = [[] for _ in range(self.size)]
        for k in range(self.size):
            p = self.parent[k]
            if p >= 0:
                kids[p].append(k)
        for lst in kids:
            lst.sort(key=lambda k: int(self.lo[k]))
        return kids


def lcp_interval_tree(lcp: np.ndarray) -> LcpIntervalTree:
    """Enumerate all lcp-intervals of an LCP array (root included)."""
    lcp = np.asarray(lcp, dtype=np.int64)
    n = len(lcp)
    depths: list[int] = []
    los: list[int] = []
    his: list[int] = []

    stack: list[list[int]] = [[0, 0]]  # (depth, lb)
    for i in range(1, n):
        l = int(lcp[i])
        lb = i - 1
        while stack and stack[-1][0] > l:
            d_, lb_ = stack.pop()
            depths.append(d_)
            los.append(lb_)
            his.append(i)
            lb = lb_
        if not stack or stack[-1][0] < l:
            stack.append([l, lb])
    while stack:
        d_, lb_ = stack.pop()
        depths.append(d_)
        los.append(lb_)
        his.append(n)

    depth = np.asarray(depths, dtype=np.int64)
    lo = np.asarray(los, dtype=np.int64)
    hi = np.asarray(his, dtype=np.int64)

    # dedupe + drop degenerate size-1 intervals
    key = lo * (n + 1) + hi
    _, first = np.unique(key, return_index=True)
    keep = np.sort(first)
    depth, lo, hi = depth[keep], lo[keep], hi[keep]
    ok = (hi - lo) >= 2
    depth, lo, hi = depth[ok], lo[ok], hi[ok]

    # parents by nesting: top-down sweep with a stack
    order = np.lexsort((-(hi - lo), lo))
    parent = np.full(len(lo), -1, dtype=np.int64)
    st: list[int] = []
    for k in order:
        while st and not (lo[st[-1]] <= lo[k] and hi[k] <= hi[st[-1]]):
            st.pop()
        if st:
            # guard against duplicate-range nodes (shouldn't happen post-dedupe)
            parent[k] = st[-1]
        st.append(int(k))
    return LcpIntervalTree(depth=depth, lo=lo, hi=hi, parent=parent)
