"""The comparison that decides ``correct``: every full-path answer against
the reference's, each number beside its limit."""

from __future__ import annotations

import numpy as np

from port_bench.reference.answers import Reference, Semantics


def ulps(a: float, b: float) -> int:
    """Distance in float32 units in the last place of two non-negative
    values."""
    ia = int(np.asarray(a, np.float32).view(np.int32))
    ib = int(np.asarray(b, np.float32).view(np.int32))
    return abs(ia - ib)


def _ranked(scores: dict, k: int):
    return scores, sorted(scores, key=lambda x: (-scores[x], x))[:k]


def _memo(fn):
    cache = {}

    def get(key, payload):
        if key not in cache:
            cache[key] = fn(payload)
        return cache[key]
    return get


def compare(answers, ref: Reference, sem: Semantics, limits: dict, control: bool = False):
    """``answers``: (kind, key, payload, result) of each full-path answer.
    With ``control`` the reference answers with a guarantee broken
    (``list``, ``topk``, ``count``) or in bfloat16 (``tfidf``) and is judged in the
    program's place.  Returns ({name: [value, limit]} for the kinds
    present, in a fixed order; whether each answer is wrong)."""
    want = {
        "list": _memo(lambda p: ref.list_docs(p, sem)),
        "topk": _memo(lambda p: ref.topk(p, sem)),
        "count": _memo(ref.count),
        "tfidf": _memo(lambda p: _ranked(ref.tfidf_scores(p, sem), sem.k)),
    }
    wrong = dict.fromkeys(want, 0)
    seen = set()
    flags = []
    worst_ulp = 0
    tie = limits.get("tfidf_score_ulp_max", 0)
    for kind, key, payload, result in answers:
        seen.add(kind)
        if kind == "tfidf":
            scores, ranked = want["tfidf"](key, payload)
            bad = len(result) != len(ranked)
            row_ulp = 0
            for (g, s), w in zip(result, ranked):
                row_ulp = max(row_ulp, ulps(s, scores[w]))
                if g != w and not (g in scores and ulps(scores[g], scores[w]) <= tie):
                    bad = True
            worst_ulp = max(worst_ulp, row_ulp)
            wrong["tfidf"] += bad
            flags.append(bad or row_ulp > tie)
        else:
            bad = result != want[kind](key, payload)
            wrong[kind] += bad
            flags.append(bad)
    out = {}
    for kind in want:
        if kind in seen:
            out[f"{kind}_rows_wrong"] = [wrong[kind], limits.get(f"{kind}_rows_wrong", 0)]
    if "tfidf" in seen:
        out["tfidf_score_ulp_max"] = [worst_ulp, tie]
    return out, flags


def control_answers(answers, ref: Reference, sem: Semantics):
    """The control's answers to the same requests: the reference with one
    stated guarantee broken (``list``: discovery order; ``topk``: half the
    buffer; ``count``: occurrences for documents) or computed in bfloat16 (``tfidf``)."""
    make = {
        "list": _memo(lambda p: ref.list_docs_discovery(p, sem)),
        "topk": _memo(lambda p: ref.topk_half_buffer(p, sem)),
        "count": _memo(ref.count_occurrences),
        "tfidf": _memo(lambda p: ref.tfidf(p, sem, bf16=True)),
    }
    return [(kind, key, payload, make[kind](key, payload))
            for kind, key, payload, _ in answers]
