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

``tfidf_topk`` is the batched engine over a batch of one.
``tfidf_topk_incremental`` is the paper's k' = 2k, 4k, ... loop with lower
and upper score bounds and an early stop, orchestrated on the host over one
``pdl_topk`` extraction per term; its weights are float64 ``np.log2`` on
the host, so its scores are the reference's exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import BIG, IDX, as_i32, lexsort_rows
from repro_torch.core.csa import CSA, csa_search_planned
from repro_torch.core.pdl import PDLIndex, pdl_doc_freqs_batch, pdl_topk
from repro_torch.core.sada import SadaCount, sada_count, sada_count_batch


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
                     k: int, conjunctive: bool, max_buf: int = 2048, dfs_batch=None,
                     n_docs: int | None = None):
    """Exact ranked-AND / ranked-OR top-k over a [Q, T] batch of term ranges
    (``ranges`` int32[Q, T, 2], empty terms lo >= hi; ``term_valid``
    bool[Q, T]): (docs int32[Q, k] padded -1, scores float32[Q, k]).

    ``dfs_batch`` (int32[Q, T]) and ``n_docs`` override the df and the
    document count of the idf weight, which default to this index's own
    Sada counts and ``pdl.d``: the sharded engine injects the collection's
    global statistics, so a shard scores a document with the float the
    whole collection's index gives it."""
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
    dfs = sada_count_batch(sada, lo, hi) if dfs_batch is None else dfs_batch.reshape(-1)
    w = idf_weight(pdl.d if n_docs is None else n_docs, dfs).reshape(Q, T)

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


def tfidf_topk(pdl: PDLIndex, csa: CSA, sada: SadaCount, ranges, term_valid, k: int,
               conjunctive: bool, max_buf: int = 2048, dfs=None, n_docs: int | None = None):
    """One query's exact ranked-AND / ranked-OR top-k (``ranges`` [T, 2],
    ``term_valid`` [T], optional ``dfs`` [T]): ``tfidf_topk_batch`` over a
    batch of one, (docs int32[k] padded -1, scores float32[k])."""
    dev = csa.device
    ranges = as_i32(ranges, dev)[None]
    term_valid = torch.as_tensor(term_valid, dtype=torch.bool, device=dev)[None]
    dfs = None if dfs is None else as_i32(dfs, dev)[None]
    docs, scores = tfidf_topk_batch(pdl, csa, sada, ranges, term_valid, k, conjunctive,
                                    max_buf, dfs_batch=dfs, n_docs=n_docs)
    return docs[0], scores[0]


# ---------------------------------------------------------------------------
# The paper's incremental algorithm (Section 6.5's numbered loop)
# ---------------------------------------------------------------------------


def tfidf_topk_incremental(pdl: PDLIndex, csa: CSA, sada: SadaCount, ranges, k: int,
                           conjunctive: bool, max_buf: int = 2048):
    """Host-orchestrated k' doubling with score bounds (steps 1-6 of
    Section 6.5): extract k' documents per term from its tf-sorted list,
    keep lower and upper bounds on w(D, Q), and stop once the top-k set
    cannot change.  ``ranges`` is a host [T, 2] array.  Returns (docs
    list, lower-bound scores list); the weights are float64 on the host.

    Each term's list comes from one ``pdl_topk`` call (one PDL gather
    launch on the card); the loop reads its prefixes, and the conjunctive
    filter checks membership against the complete lists."""
    T = len(ranges)
    d = pdl.d
    dfs = [int(sada_count(sada, int(lo), int(hi))) for lo, hi in ranges]
    gs = [float(np.log2(d / max(df, 1))) for df in dfs]

    full: list[tuple[np.ndarray, np.ndarray]] = []
    full_maps: list[dict[int, int]] = []
    for lo, hi in ranges:
        docs, tf = pdl_topk(pdl, csa, int(lo), int(hi), min(max_buf, pdl.d))
        docs, tf = docs.cpu().numpy(), tf.cpu().numpy()
        keep = docs >= 0
        full.append((docs[keep], tf[keep]))
        full_maps.append({int(a): int(b) for a, b in zip(docs[keep], tf[keep])})

    kp = 2 * k
    while True:
        # step 1: k' documents per term
        prefix: dict[int, dict[int, int]] = {}
        next_tf = []
        for t in range(T):
            docs, tf = full[t]
            head = min(kp, len(docs))
            for j in range(head):
                prefix.setdefault(int(docs[j]), {})[t] = int(tf[j])
            next_tf.append(int(tf[head]) if head < len(docs) else 0)

        # steps 3-4: lower and upper bounds of every extracted document
        lower, upper = {}, {}
        for doc, seen in prefix.items():
            lower[doc] = sum(seen.get(t, 0) * gs[t] for t in range(T))
            upper[doc] = sum((seen[t] if t in seen else next_tf[t]) * gs[t] for t in range(T))

        # step 2: the conjunctive filter against the complete lists
        if conjunctive:
            cand = {doc: w for doc, w in lower.items()
                    if all(doc in full_maps[t] for t in range(T))}
        else:
            cand = lower

        ranked = sorted(cand.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        if all(kp >= len(full[t][0]) for t in range(T)):
            return [doc for doc, _ in ranked], [w for _, w in ranked]

        # steps 5-6: stop when the top-k set cannot change
        kth = ranked[k - 1][1] if len(ranked) >= k else -np.inf
        unseen_upper = sum(next_tf[t] * gs[t] for t in range(T))
        top_set = {doc for doc, _ in ranked}
        seen_safe = all(upper[doc] <= kth for doc in cand if doc not in top_set)
        if len(ranked) >= k and unseen_upper <= kth and seen_safe:
            return [doc for doc, _ in ranked], [w for _, w in ranked]
        kp *= 2
