"""The answer each endpoint owes, worked out from the suffix and document
arrays alone, and the controls: the same answers with one stated guarantee
broken, or in a lower precision.

The semantics are the configuration's (its ``guarantees`` block):

* the planner sends a pattern to Brute-L when ``occ < threshold * df`` in
  float32, else to the PDL;
* Brute-L reads the first ``min(occ, max_buf)`` suffixes of the range;
  the PDL every document of the range;
* ``list``: the documents read, ascending, the ``max_df`` smallest;
* ``topk``: the documents read with their frequencies, the
  ``min(d + 1, max_buf)`` smallest ids kept, ranked by (tf desc, id asc),
  the first ``k``;
* ``count``: the pattern's df, the distinct documents of its whole range;
* ``tfidf``: every document of each term's range with its tf, weights
  ``lg(d / max(df, 1))`` in float32, scores folded term by term in slot
  order (a float32 multiply, then a float32 add), ranked by (score desc,
  id asc), the first ``k``; disjunctive or conjunctive.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from port_bench.reference.suffix import document_array, sa_range, suffix_array


@dataclasses.dataclass(frozen=True)
class Semantics:
    """The knobs that decide an answer: the runtime's full path and the
    planner's threshold."""

    max_df: int = 256
    max_buf: int = 1024
    k: int = 10
    conjunctive: bool = False
    max_terms: int = 4
    occ_df_threshold: float = 4.0


def to_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), held
    as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


class Reference:
    """The collection's suffix array and document array, and per pattern
    its range, occurrences and documents."""

    def __init__(self, text: np.ndarray, doc_starts: np.ndarray, d: int, sa=None):
        self.text = text
        self.d = d
        self.sa = suffix_array(text) if sa is None else sa
        self.da = document_array(self.sa, doc_starts)
        self._ranges: dict = {}
        self._tf: dict = {}

    def stats(self, pattern) -> tuple[int, int, int, int]:
        """(lo, hi, occ, df) of one pattern."""
        key = tuple(int(x) for x in pattern)
        got = self._ranges.get(key)
        if got is None:
            lo, hi = sa_range(self.text, self.sa, np.asarray(key, np.int32)) if key else (0, 0)
            df = len(np.unique(self.da[lo:hi]))
            got = self._ranges[key] = (lo, hi, hi - lo, df)
        return got

    def brute(self, occ: int, df: int, sem: Semantics) -> bool:
        return bool(np.float32(occ) < np.float32(sem.occ_df_threshold) * np.float32(max(df, 1)))

    def _read(self, pattern, sem: Semantics, max_buf: int | None = None) -> np.ndarray:
        """The document of every suffix the endpoint's engine reads."""
        lo, hi, occ, df = self.stats(pattern)
        if occ and self.brute(occ, df, sem):
            hi = lo + min(occ, sem.max_buf if max_buf is None else max_buf)
        return self.da[lo:hi]

    # -- the answers ---------------------------------------------------------

    def list_docs(self, pattern, sem: Semantics) -> list[int]:
        return np.unique(self._read(pattern, sem))[: sem.max_df].tolist()

    def topk(self, pattern, sem: Semantics, max_buf: int | None = None) -> list[tuple]:
        docs, tf = np.unique(self._read(pattern, sem, max_buf), return_counts=True)
        keep = min(self.d + 1, sem.max_buf)
        docs, tf = docs[:keep], tf[:keep]
        order = np.lexsort((docs, -tf))[: sem.k]
        return [(int(x), int(t)) for x, t in zip(docs[order], tf[order])]

    def count(self, pattern) -> int:
        return self.stats(pattern)[3]

    def tf(self, pattern) -> np.ndarray:
        """int64[d]: the pattern's occurrences in each document."""
        key = tuple(int(x) for x in pattern)
        got = self._tf.get(key)
        if got is None:
            lo, hi, _, _ = self.stats(pattern)
            got = self._tf[key] = np.bincount(self.da[lo:hi], minlength=self.d)
        return got

    def tfidf_scores(self, terms, sem: Semantics, bf16: bool = False) -> dict:
        """Every candidate document's score, as the endpoint folds it
        (float32 arrays over all documents, one term at a time)."""
        rnd = to_bf16 if bf16 else (lambda x: np.asarray(x, np.float32))
        terms = list(terms)[: sem.max_terms]
        score = rnd(np.zeros(self.d, np.float32))
        hits = []
        for t in terms:
            tf = self.tf(t)
            df = int(np.count_nonzero(tf))
            w = rnd(np.float32(np.log2(np.float64(np.float32(self.d) / np.float32(max(df, 1))))))
            score = rnd(score + rnd(tf.astype(np.float32) * w))
            hits.append(tf > 0)
        if not hits:
            return {}
        cand = np.logical_and.reduce(hits) if sem.conjunctive else np.logical_or.reduce(hits)
        docs = np.flatnonzero(cand)
        return dict(zip(docs.tolist(), score[docs].tolist()))

    def tfidf(self, terms, sem: Semantics, bf16: bool = False) -> list[tuple]:
        scores = self.tfidf_scores(terms, sem, bf16)
        ranked = sorted(scores, key=lambda x: (-scores[x], x))[: sem.k]
        return [(x, scores[x]) for x in ranked]

    # -- the controls ----------------------------------------------------------

    def list_docs_discovery(self, pattern, sem: Semantics) -> list[int]:
        """Control: the first ``max_df`` distinct documents in suffix
        order, unsorted (breaks "ascending, the smallest ids")."""
        _, first = np.unique(self._read(pattern, sem), return_index=True)
        return self._read(pattern, sem)[np.sort(first)][: sem.max_df].tolist()

    def topk_half_buffer(self, pattern, sem: Semantics) -> list[tuple]:
        """Control: Brute-L's frequencies over half its buffer (breaks
        "tf over the first ``max_buf`` occurrences")."""
        return self.topk(pattern, sem, max_buf=sem.max_buf // 2)

    def count_occurrences(self, pattern) -> int:
        """Control: the pattern's occurrences, not its documents (breaks
        "distinct documents")."""
        return self.stats(pattern)[2]
