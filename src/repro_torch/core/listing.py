"""Baseline document listing and top-k (counterpart of
``repro.core.listing``, the paper's Section 6.2.1 / 6.3.1 baselines):

* Brute-D — distinct ids (+ freqs) of the stored DA[lo, hi) window;
* Brute-L — the same, the ids located through the CSA;
* Sada-C  — Sadakane's RMQ recursion over C with V-marking (Sada-C-D with
  a stored DA, Sada-C-L through the CSA), through the port's kernel
  (``repro_torch.kernels.sada_c_list``).

Every ``*_batch`` executor takes int32[B] range arrays where a masked-out
query is the empty range (0, 0), and returns padded (B, max_df) document
rows with -1 past each query's count.  The single-range forms are their
batch functions over a batch of one.
"""

from __future__ import annotations

import torch

from repro_torch.common import BIG, IDX, arange_i32, batch_of_one, lexsort_rows
from repro_torch.core.csa import CSA, csa_doc_of, csa_lookup
from repro_torch.kernels.sada_c_list import sada_c_list
from repro_torch.succinct.rmq import SparseTableRMQ


def _distinct_from_window(window, valid, max_df: int):
    """Row-wise distinct ids of a gathered doc-id window (int32[B, W]) under
    a validity mask: (docs[B, max_df] ascending, -1 padded; count[B];
    freqs[B, max_df]).  Writes the reference drops land in one extra
    column that is sliced off."""
    B, W = window.shape
    dev = window.device
    keys = torch.where(valid, window, BIG)
    s = torch.sort(keys, dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    is_doc = s < BIG
    new_doc = first & is_doc
    idx_among_new = torch.cumsum(new_doc.to(IDX), 1, dtype=IDX) - 1
    scatter_idx = torch.where(new_doc & (idx_among_new < max_df), idx_among_new, max_df)
    docs = torch.full((B, max_df + 1), -1, dtype=IDX, device=dev)
    docs.scatter_(1, scatter_idx.long(), s)
    count = torch.clamp(new_doc.sum(1), max=max_df).to(IDX)
    # frequencies: segment boundaries in the sorted window
    n_doc = is_doc.sum(1, keepdim=True).to(IDX)
    starts = n_doc.expand(B, max_df + 2).clone()
    pos = torch.arange(W, dtype=IDX, device=dev).expand(B, W)
    starts_idx = torch.where(new_doc & (idx_among_new < max_df + 1), idx_among_new, max_df + 1)
    starts.scatter_(1, starts_idx.long(), pos)
    starts = starts[:, : max_df + 1]
    live = torch.arange(max_df, device=dev)[None, :] < count[:, None]
    freqs = torch.where(live, starts[:, 1:] - starts[:, :-1], 0).to(IDX)
    docs = torch.where(live, docs[:, :max_df], -1).to(IDX)
    return docs, count, freqs


def brute_list_csa_batch(csa: CSA, lo, hi, max_occ: int, max_df: int):
    """Brute-L over a range batch: ids of SA[lo, lo + max_occ) by CSA
    locate + B-rank, masked against hi: (docs[B, max_df], count[B], freqs)."""
    idx = lo[:, None] + torch.arange(max_occ, dtype=IDX, device=lo.device)[None, :]
    valid = idx < hi[:, None]
    text_pos = csa_lookup(csa, torch.clamp(idx, max=csa.n - 1))
    return _distinct_from_window(csa_doc_of(csa, text_pos), valid, max_df)


def brute_topk_batch(docs, counts, freqs, k: int):
    """Row-wise top-k of ``brute_list_csa_batch`` output by (tf desc, id
    asc): (docs int32[B, k] padded -1, tf int32[B, k])."""
    B, max_df = docs.shape
    dev = docs.device
    valid = torch.arange(max_df, device=dev)[None, :] < counts[:, None]
    top = lexsort_rows(torch.where(valid, -freqs, BIG),
                       torch.where(valid, docs, BIG))[:, :k]
    kk = top.shape[1]
    out_docs = torch.full((B, k), -1, dtype=IDX, device=dev)
    out_tf = torch.zeros((B, k), dtype=IDX, device=dev)
    out_docs[:, :kk] = torch.gather(docs, 1, top)
    out_tf[:, :kk] = torch.gather(freqs, 1, top)
    ok = torch.arange(k, device=dev)[None, :] < torch.clamp(counts, max=k)[:, None]
    return torch.where(ok, out_docs, -1).to(IDX), torch.where(ok, out_tf, 0).to(IDX)


def brute_list_csa(csa: CSA, lo, hi, max_occ: int, max_df: int | None = None):
    """Brute-L for one range (ints or one-element tensors): (docs[max_df],
    count, freqs[max_df]), ``brute_list_csa_batch`` over a batch of one."""
    max_df = max_df or max_occ
    dev = csa.device
    docs, count, freqs = brute_list_csa_batch(csa, batch_of_one(lo, dev),
                                              batch_of_one(hi, dev), max_occ, max_df)
    return docs[0], count[0], freqs[0]


def brute_topk(docs, count, freqs, k: int):
    """Top-k of one ``brute_list_csa`` row by (tf desc, id asc):
    (docs int32[k] padded -1, tf int32[k])."""
    top_docs, top_tf = brute_topk_batch(docs[None], batch_of_one(count, docs.device),
                                        freqs[None], k)
    return top_docs[0], top_tf[0]


def brute_list_da_batch(da, lo, hi, max_occ: int, max_df: int):
    """Brute-D over a range batch: the distinct ids of the stored
    DA[lo, lo + max_occ), masked against hi: (docs[B, max_df], count[B],
    freqs[B, max_df]).  Ranges longer than ``max_occ`` are truncated."""
    idx = lo[:, None] + arange_i32(max_occ, lo.device)[None, :]
    valid = idx < hi[:, None]
    window = da[torch.clamp(idx, max=da.shape[0] - 1).long()]
    return _distinct_from_window(window, valid, max_df)


def brute_list_da(da, lo, hi, max_occ: int, max_df: int | None = None):
    """Brute-D for one range (ints or one-element tensors): (docs[max_df],
    count, freqs[max_df])."""
    max_df = max_df or max_occ
    dev = da.device
    docs, count, freqs = brute_list_da_batch(da, batch_of_one(lo, dev),
                                             batch_of_one(hi, dev), max_occ, max_df)
    return docs[0], count[0], freqs[0]


# ---------------------------------------------------------------------------
# Sadakane's algorithm over the C array (Sada-C)
# ---------------------------------------------------------------------------


def sada_c_list_docs_batch(rmq_c: SparseTableRMQ, source, lo, hi, d: int, max_df: int):
    """Sada-C over a range batch, DA read from ``source`` (a stored
    int32[n] DA, or a CSA): (docs int32[B, max_df] padded -1, in discovery
    order; count[B])."""
    return sada_c_list(rmq_c.values, rmq_c.table, source, lo.contiguous(),
                       hi.contiguous(), d=d, max_df=max_df)


def sada_c_list_docs_da_batch(rmq_c: SparseTableRMQ, da, lo, hi, d: int, max_df: int):
    """Sada-C-D over a range batch (the reference vmaps
    ``sada_c_list_docs_da``)."""
    return sada_c_list_docs_batch(rmq_c, da, lo, hi, d, max_df)


def sada_c_list_docs_csa_batch(rmq_c: SparseTableRMQ, csa: CSA, lo, hi, max_df: int):
    """Sada-C-L over a range batch (the reference vmaps
    ``sada_c_list_docs_csa``)."""
    return sada_c_list_docs_batch(rmq_c, csa, lo, hi, csa.d, max_df)


def sada_c_list_docs(rmq_c: SparseTableRMQ, source, lo, hi, d: int, max_df: int):
    """Sada-C for one range (ints or one-element tensors), DA from a stored
    array or a CSA: (docs int32[max_df] padded -1, in discovery order;
    count)."""
    dev = rmq_c.values.device
    docs, cnt = sada_c_list_docs_batch(rmq_c, source, batch_of_one(lo, dev),
                                       batch_of_one(hi, dev), d, max_df)
    return docs[0], cnt[0]


def sada_c_list_docs_da(rmq_c: SparseTableRMQ, da, lo, hi, d: int, max_df: int):
    return sada_c_list_docs(rmq_c, da, lo, hi, d, max_df)


def sada_c_list_docs_csa(rmq_c: SparseTableRMQ, csa: CSA, lo, hi, max_df: int):
    return sada_c_list_docs(rmq_c, csa, lo, hi, csa.d, max_df)
