"""TF-IDF ranked multi-term queries (Section 6.5; counterpart of
``repro.core.tfidf``).

    w(D, Q) = sum_i tf(D, q_i) * g(df(q_i)),   g(df) = lg(d / max(df, 1))

The composition is the reference's: CSA ranges for the terms (one
backward-search launch over every term of the batch), the top-k PDL's
per-term (doc, tf) lists, Sadakane counting for df.  The batch is written
out as [Q, T] directly.  Scores fold term-major in slot order in float32,
a multiply then an add per term (two separate elementwise kernels, so no
fused multiply-add), which makes a document's score depend only on its own
tf values and the weights.
"""

from __future__ import annotations

import torch

from repro_torch.common import BIG, IDX, lexsort_rows
from repro_torch.core.csa import CSA, csa_search_planned
from repro_torch.core.pdl import PDLIndex, pdl_doc_freqs_batch
from repro_torch.core.sada import SadaCount, sada_count_batch


def idf_weight(d: int, df):
    """g(df) = lg(d / max(df, 1)) in float32.  ``d`` is filled on the
    device: a captured program may not copy from the host."""
    ratio = torch.full((), float(d), dtype=torch.float32, device=df.device) \
        / torch.clamp(df, min=1).to(torch.float32)
    return torch.log2(ratio)


def rank_topk_scores(docs, scores, ok, k: int):
    """Row-wise rank by (score desc, doc asc), take k: (docs int32[Q, k]
    padded -1, scores float32[Q, k]).  ``docs`` holds INT32_MAX for absent
    entries."""
    neg = torch.where(ok, -scores, torch.inf)
    dkey = torch.where(ok, docs, BIG)
    top = lexsort_rows(neg, dkey)[:, :k]
    topd = torch.gather(dkey, 1, top)
    good = topd < BIG
    return (torch.where(good, topd, -1).to(IDX),
            torch.where(good, -torch.gather(neg, 1, top), 0.0).to(torch.float32))


def tfidf_topk_batch(pdl: PDLIndex, csa: CSA, sada: SadaCount, ranges, term_valid,
                     k: int, conjunctive: bool, max_buf: int = 2048):
    """Exact ranked-AND / ranked-OR top-k over a [Q, T] batch of term ranges
    (``ranges`` int32[Q, T, 2], empty terms lo >= hi; ``term_valid``
    bool[Q, T]): (docs int32[Q, k] padded -1, scores float32[Q, k])."""
    Q, T, _ = ranges.shape
    dev = ranges.device
    lo = ranges[..., 0].reshape(-1).contiguous()
    hi = ranges[..., 1].reshape(-1).contiguous()
    docs, tf, nseg = pdl_doc_freqs_batch(pdl, csa, lo, hi, max_buf=max_buf)
    keep = term_valid.reshape(-1, 1) & \
        (torch.arange(max_buf, device=dev)[None, :] < nseg[:, None])
    # rows stay ascending: the invalid tails are INT32_MAX
    docs = torch.where(keep, docs, BIG).reshape(Q, T, max_buf)
    tf = torch.where(keep, tf, 0).reshape(Q, T, max_buf)
    w = idf_weight(pdl.d, sada_count_batch(sada, lo, hi)).reshape(Q, T)

    # candidates: each distinct document of a query's term lists once
    s_docs = torch.sort(docs.reshape(Q, T * max_buf), dim=1).values
    first = torch.ones_like(s_docs, dtype=torch.bool)
    first[:, 1:] = s_docs[:, 1:] != s_docs[:, :-1]
    cand_ok = first & (s_docs < BIG)
    cand = torch.where(cand_ok, s_docs, BIG).contiguous()

    # fixed-order weighted fold over the term slots
    score = torch.zeros(cand.shape, dtype=torch.float32, device=dev)
    seg_terms = torch.zeros(cand.shape, dtype=IDX, device=dev)
    for t in range(T):
        row = docs[:, t, :].contiguous()
        j = torch.clamp(torch.searchsorted(row, cand), 0, max_buf - 1)
        hit = (torch.gather(row, 1, j) == cand) & cand_ok
        tf_hit = torch.where(hit, torch.gather(tf[:, t, :], 1, j), 0)
        score = score + tf_hit.to(torch.float32) * w[:, t, None]
        seg_terms += hit.to(IDX)

    ok = cand_ok
    if conjunctive:
        ok = ok & (seg_terms == term_valid.sum(1, dtype=IDX)[:, None])
    return rank_topk_scores(cand, score, ok, k)


def term_ranges_batch(csa: CSA, patterns, lengths):
    """SA ranges of a [Q, T, max_m] term batch (lengths int32[Q, T], 0 for
    an absent slot) in one backward-search launch over all Q*T terms:
    (ranges int32[Q, T, 2], valid bool[Q, T])."""
    Q, T, m = patterns.shape
    lo, hi = csa_search_planned(csa, patterns.reshape(Q * T, m), lengths.reshape(-1))
    hi = torch.where(lengths.reshape(-1) > 0, hi, lo)
    return torch.stack([lo, hi], dim=-1).reshape(Q, T, 2), lengths > 0
