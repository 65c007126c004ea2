"""The suffix array, the document array and pattern ranges, in NumPy.

The suffix array is the plain one of the whole text (terminators compare
as the symbol 0 and the comparison runs on past them), built by prefix
doubling: each round sorts by (rank of i, rank of i + k), the end of the
text ranking below every symbol, until every rank is distinct.  It is
unique, so any correct construction gives the same array.
"""

from __future__ import annotations

import numpy as np


def suffix_array(text: np.ndarray) -> np.ndarray:
    n = len(text)
    if n == 0:
        return np.zeros(0, np.int32)
    rank = text.astype(np.int64)
    k = 1
    while True:
        second = np.full(n, -1, np.int64)
        if k < n:
            second[: n - k] = rank[k:]
        key = rank * (n + 2) + (second + 1)
        sa = np.argsort(key, kind="stable")
        sorted_keys = key[sa]
        new = np.empty(n, np.int64)
        new[sa] = np.concatenate([[0], np.cumsum(sorted_keys[1:] != sorted_keys[:-1])])
        rank = new
        if rank[sa[-1]] == n - 1:
            return sa.astype(np.int32)
        k *= 2


def document_array(sa: np.ndarray, doc_starts: np.ndarray) -> np.ndarray:
    """DA[i]: the document holding suffix SA[i]."""
    return (np.searchsorted(doc_starts, sa, side="right") - 1).astype(np.int32)


def sa_range(text: np.ndarray, sa: np.ndarray, pattern: np.ndarray) -> tuple[int, int]:
    """[lo, hi): the suffixes that start with ``pattern``."""
    m = len(pattern)
    pat = tuple(int(x) for x in pattern)

    def prefix(i: int):
        seg = text[i:i + m]
        return tuple(int(x) for x in seg) + (-1,) * (m - len(seg))

    lo, hi = 0, len(sa)
    while lo < hi:
        mid = (lo + hi) // 2
        if prefix(int(sa[mid])) < pat:
            lo = mid + 1
        else:
            hi = mid
    start, hi = lo, len(sa)
    while lo < hi:
        mid = (lo + hi) // 2
        if prefix(int(sa[mid])) <= pat:
            lo = mid + 1
        else:
            hi = mid
    return start, lo
