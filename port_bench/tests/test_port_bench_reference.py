"""The reference against a brute-force scan on tiny collections, and the
frozen generators against the program's."""

from __future__ import annotations

import numpy as np
import pytest

from port_bench.reference.answers import Reference, Semantics, to_bf16
from port_bench.reference.collection import generate
from port_bench.reference.judge import compare, control_answers, ulps
from port_bench.reference.suffix import sa_range, suffix_array
from port_bench.traffic.clients import Clients
from port_bench.traffic.patterns import pattern_pool

SPECS = [("dna", 1, 12, 120, 0.01, "acgt", 5), ("version", 3, 4, 90, 0.02, "acgt", 6),
         ("concat", 2, 3, 60, 0.05, "acgt", 7)]


def _naive_sa(text):
    n = len(text)
    return np.asarray(sorted(range(n), key=lambda i: text[i:].tolist()), np.int32)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s[0])
def test_suffix_array_and_ranges_match_a_scan(spec):
    coll = generate(*spec[:6], seed=spec[6])
    sa = suffix_array(coll.text)
    assert np.array_equal(sa, _naive_sa(coll.text))
    rng = np.random.default_rng(1)
    for _ in range(20):
        p = int(rng.integers(0, coll.n - 4))
        pat = coll.text[p:p + int(rng.integers(1, 5))]
        lo, hi = sa_range(coll.text, sa, pat)
        starts = {i for i in range(coll.n) if coll.text[i:i + len(pat)].tolist() == pat.tolist()}
        assert set(sa[lo:hi].tolist()) == starts


def _docs_of(coll, pat):
    """(doc, tf) of every document holding ``pat``, by scanning the text."""
    tf = {}
    for doc, (s, e) in enumerate(zip(coll.doc_starts, coll.doc_ends)):
        seg = coll.text[s:e].tolist()
        c = sum(seg[i:i + len(pat)] == pat.tolist() for i in range(len(seg) - len(pat) + 1))
        if c:
            tf[doc] = c
    return tf


@pytest.mark.parametrize("max_df", [3, 256])
def test_answers_match_a_scan(max_df):
    coll = generate("dna", 1, 12, 200, 0.02, "acgt", seed=11)
    ref = Reference(coll.text, coll.doc_starts, coll.d)
    sem = Semantics(max_df=max_df, max_buf=4096, k=4, occ_df_threshold=0.0)  # every row PDL
    rng = np.random.default_rng(2)
    pats = [coll.text[p:p + 3] for p in rng.integers(0, coll.n - 3, 30)]
    pats = [p for p in pats if (p > 0).all()]
    for p in pats:
        tf = _docs_of(coll, p)
        assert ref.list_docs(p, sem) == sorted(tf)[:max_df]
        assert ref.count(p) == len(tf)
        assert ref.topk(p, sem) == sorted(tf.items(), key=lambda kv: (-kv[1], kv[0]))[:4]
    q = pats[:2]
    tfs = [_docs_of(coll, t) for t in q]
    w = [np.float32(np.log2(np.float64(np.float32(coll.d) / np.float32(len(t))))) for t in tfs]
    want = {x: float(np.float32(np.float32(0) + np.float32(tfs[0].get(x, 0) * w[0]))
                     + np.float32(np.float32(tfs[1].get(x, 0)) * w[1]))
            for x in set(tfs[0]) | set(tfs[1])}
    assert ref.tfidf_scores(q, sem) == pytest.approx(want, rel=0, abs=0)


def test_brute_rows_read_only_the_buffer():
    coll = generate("dna", 1, 40, 100, 0.001, "acgt", seed=3)
    ref = Reference(coll.text, coll.doc_starts, coll.d)
    pat = coll.text[10:12]
    lo, hi, occ, df = ref.stats(pat)
    sem = Semantics(max_df=256, max_buf=8, occ_df_threshold=1e9)  # every row Brute-L
    assert ref.list_docs(pat, sem) == np.unique(ref.da[lo:lo + min(occ, 8)]).tolist()


def test_generators_are_the_programs():
    from repro_torch.data.collections import (
        SyntheticSpec,
        random_substring_patterns,
    )
    from repro_torch.data.collections import generate as port_generate

    for fam, nb, nv, bl, rate, alpha, seed in SPECS:
        mine = generate(fam, nb, nv, bl, rate, alpha, seed=seed)
        theirs = port_generate(SyntheticSpec(fam, nb, nv, bl, rate, seed=seed))
        assert np.array_equal(mine.text, theirs.text)
        assert np.array_equal(mine.doc_starts, theirs.doc_starts) and mine.d == theirs.d
        ref = Reference(mine.text, mine.doc_starts, mine.d)
        got = pattern_pool(ref, 300, 4, 20, seed=9)
        want = random_substring_patterns(theirs, 300, 4, 20, seed=9, device="cpu")
        assert [p.tolist() for p in got] == [p.tolist() for p in want]


def test_rare_pool_ranks_by_df():
    coll = generate("dna", 1, 30, 300, 0.005, "acgt", seed=8)
    ref = Reference(coll.text, coll.doc_starts, coll.d)
    dfs = [ref.stats(p)[3] for p in pattern_pool(ref, 500, 5, 40, seed=2, rank="df")]
    assert dfs == sorted(dfs) and dfs[0] < coll.d


def test_bf16_rounding():
    x = np.asarray([1.0, 1.00390625, 1.005859375, 3.14159], np.float32)
    assert to_bf16(x).tolist() == [1.0, 1.0, 1.0078125, 3.140625]
    assert ulps(1.0, np.nextafter(np.float32(1.0), np.float32(2.0))) == 1


@pytest.mark.parametrize("kind", ["list", "topk", "tfidf", "count"])
def test_reference_passes_and_control_fails(kind):
    """The reference's own answers compare clean; the control's do not."""
    coll = generate("dna", 1, 24, 400, 0.001, "acgt", seed=21)
    ref = Reference(coll.text, coll.doc_starts, coll.d)
    pools = {"common": pattern_pool(ref, 400, 6, 32, seed=4),
             "rare": pattern_pool(ref, 400, 6, 32, seed=4, rank="df")}
    sem = Semantics(max_df=16, max_buf=32)
    clients = Clients({"kinds": {kind: 1}, "terms": ["common", "rare"], "clients": 1}, pools,
                      seed=5)
    reqs = [clients.draw() for _ in range(200)]
    make = {"list": ref.list_docs, "topk": ref.topk, "tfidf": ref.tfidf,
            "count": lambda p, sem: ref.count(p)}[kind]
    answers = [(k, key, p, make(p, sem)) for k, key, p in reqs]
    limits = {f"{kind}_rows_wrong": 0, "tfidf_score_ulp_max": 2}
    numbers, flags = compare(answers, ref, sem, limits)
    assert all(v <= lim for v, lim in numbers.values()) and not any(flags)
    numbers, flags = compare(control_answers(answers, ref, sem), ref, sem, limits)
    assert any(v > lim for v, lim in numbers.values()) and any(flags)
