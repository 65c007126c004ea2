"""Suffix-array machinery: SA, LCP, document array, C array, ILCP inputs.

Counterpart of ``repro.core.suffix``.  The suffix array is built by prefix
doubling on the device: every round is two stable sorts (by the second
key, then by the rank — the reference's ``lexsort((key2, rank))``), a
boundary scan and a scatter.  The per-round rank tables are kept, and any
pairwise LCP is an O(lg n) descent over them; that one primitive gives the
LCP array, Muthukrishnan's C array and the ILCP array (Lemma 1).

Sentinel semantics are the reference's: documents are concatenated with a
shared terminator 0 after each, and SA is the plain suffix array of the
concatenation.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.common import IDX, arange_i32, as_i32, resolve_device, searchsorted_i32


# ---------------------------------------------------------------------------
# Collection assembly (host numpy, as in the reference)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Collection:
    """A concatenated document collection T = S_0 $ S_1 $ ... $ S_{d-1} $.

    text:       int32[n]   symbols; 0 is the per-document terminator
    doc_starts: int32[d]   start offset of each document
    doc_ends:   int32[d]   offset of each document's terminator
    d:          number of documents
    sigma:      alphabet size including the terminator (max symbol + 1)
    """

    text: np.ndarray
    doc_starts: np.ndarray
    doc_ends: np.ndarray
    d: int
    sigma: int

    @property
    def n(self) -> int:
        return int(self.text.shape[0])

    def doc_of(self, pos: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.doc_starts, pos, side="right") - 1


def concat_documents(docs: Sequence) -> Collection:
    """Concatenate documents (strings or int arrays) with terminators.

    String documents are mapped byte-wise to [1, 256]; integer documents
    must be >= 0 and are shifted by +1 so that 0 is free for the terminator.
    """
    arrays = []
    for doc in docs:
        if isinstance(doc, str):
            a = np.frombuffer(doc.encode("utf-8"), dtype=np.uint8).astype(np.int32) + 1
        else:
            a = np.asarray(doc, dtype=np.int32) + 1
            if a.size and a.min() < 1:
                raise ValueError("integer documents must have symbols >= 0")
        arrays.append(a)
    starts, ends, parts = [], [], []
    off = 0
    for a in arrays:
        starts.append(off)
        parts.append(a)
        off += len(a)
        ends.append(off)
        parts.append(np.zeros(1, dtype=np.int32))
        off += 1
    text = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int32)
    sigma = int(text.max()) + 1 if text.size else 1
    return Collection(
        text=text,
        doc_starts=np.asarray(starts, dtype=np.int32),
        doc_ends=np.asarray(ends, dtype=np.int32),
        d=len(arrays),
        sigma=sigma,
    )


def subcollection(coll: Collection, dlo: int, dhi: int) -> Collection:
    """The contiguous document slice ``[dlo, dhi)`` of ``coll`` as its own
    Collection, the unit a docs-axis shard indexes.

    The slice keeps the parent's global ``sigma``, so every shard's wavelet
    matrix has the same levels and a pattern encodes the same against
    every shard.  Each document ends in its own terminator and patterns
    never hold it, so a pattern's occurrences inside documents
    ``[dlo, dhi)`` are exactly its occurrences inside the slice."""
    if not (0 <= dlo <= dhi <= coll.d):
        raise ValueError(f"document slice [{dlo}, {dhi}) out of range for d={coll.d}")
    if dlo == dhi:
        return Collection(text=np.zeros(0, dtype=np.int32),
                          doc_starts=np.zeros(0, dtype=np.int32),
                          doc_ends=np.zeros(0, dtype=np.int32), d=0, sigma=coll.sigma)
    base = int(coll.doc_starts[dlo])
    stop = int(coll.doc_ends[dhi - 1]) + 1  # the last terminator too
    return Collection(
        text=np.ascontiguousarray(coll.text[base:stop]),
        doc_starts=(coll.doc_starts[dlo:dhi] - base).astype(np.int32),
        doc_ends=(coll.doc_ends[dlo:dhi] - base).astype(np.int32),
        d=dhi - dlo,
        sigma=coll.sigma,
    )


def encode_pattern(pattern) -> np.ndarray:
    """A query pattern in symbol space, mapped as ``concat_documents`` maps
    documents (strings byte-wise + 1, integers + 1)."""
    if isinstance(pattern, str):
        return np.frombuffer(pattern.encode("utf-8"), dtype=np.uint8).astype(np.int32) + 1
    return np.asarray(pattern, dtype=np.int32) + 1


# ---------------------------------------------------------------------------
# Prefix-doubling suffix array (device) + retained rank tables
# ---------------------------------------------------------------------------


def _dense_ranks(sorted_keys: list[torch.Tensor]) -> torch.Tensor:
    """Dense rank of each position of key tuples already in sorted order."""
    n = sorted_keys[0].shape[0]
    change = torch.zeros(n, dtype=torch.bool, device=sorted_keys[0].device)
    for k in sorted_keys:
        change[1:] |= k[1:] != k[:-1]
    return torch.cumsum(change.to(IDX), 0, dtype=IDX)


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def suffix_array_doubling(coll: Collection, device="cuda"):
    """Return (sa, rank_tables) where rank_tables[j] ranks the length-2^j
    substrings (rank_tables[0] = single-symbol ranks).  Every round runs
    as device sorts; ``int(rank.max())`` syncs once per round."""
    dev = resolve_device(device)
    n = coll.n
    if n == 0:
        z = torch.zeros(0, dtype=IDX, device=dev)
        return z, [z]
    text = as_i32(coll.text, dev)
    order = _stable_argsort(text)
    rank = torch.empty(n, dtype=IDX, device=dev)
    rank[order] = _dense_ranks([text[order]])
    tables = [rank]
    idx = arange_i32(n, dev)
    k = 1
    while True:
        if int(rank.max()) == n - 1:
            sa = _stable_argsort(rank)
            break
        key2 = torch.where(idx + k < n, rank[torch.clamp(idx + k, max=n - 1)], -1)
        o1 = _stable_argsort(key2)
        order = o1[_stable_argsort(rank[o1])]
        dense = _dense_ranks([rank[order], key2[order]])
        rank = torch.empty(n, dtype=IDX, device=dev)
        rank[order] = dense
        tables.append(rank)
        sa = order
        k *= 2
        if k >= 2 * n:  # all suffixes must be distinct by now
            break
    return sa.to(IDX), tables


def pairwise_lcp(tables: list, a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Char-LCP of the suffixes starting at positions a and b: descend the
    doubling rank tables from the widest span."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    res = torch.zeros_like(a)
    for j in range(len(tables) - 1, -1, -1):
        ai = a + res
        bi = b + res
        ok = (ai < n) & (bi < n)
        t = tables[j]
        ok &= t[torch.clamp(ai, max=n - 1)] == t[torch.clamp(bi, max=n - 1)]
        res = torch.where(ok, res + (1 << j), res)
    return res.to(IDX)


# ---------------------------------------------------------------------------
# Full build product
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SuffixData:
    """Build artifact shared by every index in repro_torch.core (tensors
    on the build device).

    sa:    int32[n]  suffix array
    rank:  int32[n]  inverse permutation of sa
    lcp:   int32[n]  global LCP array (lcp[0] = 0)
    da:    int32[n]  document array
    c:     int32[n]  Muthukrishnan's C: previous SA position with the same
                     document (-1 if none)
    ilcp:  int32[n]  interleaved LCP array (Definition 1)
    """

    coll: Collection
    sa: torch.Tensor
    rank: torch.Tensor
    lcp: torch.Tensor
    da: torch.Tensor
    c: torch.Tensor
    ilcp: torch.Tensor

    @property
    def n(self) -> int:
        return self.coll.n

    @property
    def d(self) -> int:
        return self.coll.d

    @property
    def device(self) -> torch.device:
        return self.sa.device


def build_suffix_data(coll: Collection, device="cuda") -> SuffixData:
    dev = resolve_device(device)
    n = coll.n
    sa, tables = suffix_array_doubling(coll, dev)
    rank = torch.empty(n, dtype=IDX, device=dev)
    rank[sa] = arange_i32(n, dev)

    lcp = torch.zeros(n, dtype=IDX, device=dev)
    if n > 1:
        lcp[1:] = pairwise_lcp(tables, sa[:-1], sa[1:], n)

    da = searchsorted_i32(as_i32(coll.doc_starts, dev), sa, right=True) - 1

    # C array: previous SA position with the same document
    order = _stable_argsort(da)  # groups docs, increasing SA position
    da_sorted = da[order]
    same_doc = torch.zeros(n, dtype=torch.bool, device=dev)
    prev = torch.full((n,), -1, dtype=IDX, device=dev)
    if n > 1:
        same_doc[1:] = da_sorted[1:] == da_sorted[:-1]
        prev[1:] = order[:-1].to(IDX)
    c = torch.empty(n, dtype=IDX, device=dev)
    c[order] = torch.where(same_doc, prev, -1).to(IDX)

    # ILCP via Lemma 1: within-document LCP against the previous same-doc suffix
    ilcp = torch.zeros(n, dtype=IDX, device=dev)
    has_prev = c >= 0
    if bool(has_prev.any()):
        ilcp[has_prev] = pairwise_lcp(tables, sa[c[has_prev]], sa[has_prev], n)
    return SuffixData(coll=coll, sa=sa, rank=rank, lcp=lcp, da=da, c=c, ilcp=ilcp)


# ---------------------------------------------------------------------------
# Host binary search (workload construction and oracles)
# ---------------------------------------------------------------------------


def _sa_range(text: np.ndarray, sa: np.ndarray, pattern) -> tuple[int, int]:
    n = len(text)
    pattern = np.asarray(pattern, dtype=np.int32)
    m = len(pattern)
    pat = tuple(int(x) for x in pattern)

    def prefix_of(i):
        seg = text[i : i + m]
        return tuple(int(x) for x in seg) + ((-1,) * (m - len(seg)))

    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) // 2
        if prefix_of(int(sa[mid])) < pat:
            lo = mid + 1
        else:
            hi = mid
    start = lo
    lo, hi = start, n
    while lo < hi:
        mid = (lo + hi) // 2
        if prefix_of(int(sa[mid])) <= pat:
            lo = mid + 1
        else:
            hi = mid
    return start, lo


def sa_range_for_pattern(data: SuffixData, pattern) -> tuple[int, int]:
    """[lo, hi) SA range of the suffixes prefixed by ``pattern`` (symbol
    space), by binary search on the suffix array on the host."""
    return _sa_range(data.coll.text, data.sa.cpu().numpy(), pattern)


# ---------------------------------------------------------------------------
# Naive oracles (tests and small-scale validation)
# ---------------------------------------------------------------------------


def naive_suffix_array(coll: Collection) -> np.ndarray:
    """O(n^2 log n) oracle: plain suffix comparison of T (shared $)."""
    text = coll.text
    return np.asarray(sorted(range(coll.n), key=lambda i: tuple(text[i:])), dtype=np.int32)


def naive_lcp_of(coll: Collection, a: int, b: int) -> int:
    """Character LCP of the suffixes at text positions a and b."""
    text = coll.text
    h = 0
    while a + h < coll.n and b + h < coll.n and text[a + h] == text[b + h]:
        h += 1
    return h
