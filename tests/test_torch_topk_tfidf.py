"""Port parity of the ``topk`` and ``tfidf`` endpoints and the executors
behind them.

The port's service, built by the port (``built``) and over the reference's
own index carried across by ``repro_torch.convert`` (``carried``), stands
beside the JAX ``RetrievalService`` on the same collections.  Integers
(top-k documents and frequencies, PDL arrays, term ranges) must equal the
reference's, dtype included.

tf-idf tolerance.  The reference's ``jnp.log2`` is XLA's ``log(x) / log(2)``
in float32; the port calls ``torch.log2``.  The two idf weights differ by up
to 2 ulp (``test_idf_weight_within_2_ulp``), and with the reference's weights
injected the port's scores are bit-identical (``test_tfidf_fold_is_the_
references``), so the fold itself is exact.  Scores are therefore held to
2 ulp, and document ids exactly except where the port and the reference
order two candidates whose reference scores lie within 2 ulp of each other.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import listing as jlisting
from repro.core import pdl as jpdl
from repro.core import tfidf as jtfidf
from repro.data import collections as jcoll
from repro.serve.retrieval import RetrievalService as JService
from repro_torch import convert
from repro_torch.core import listing as tlisting
from repro_torch.core import pdl as tpdl
from repro_torch.core import tfidf as ttfidf
from repro_torch.core.suffix import Collection, build_suffix_data
from repro_torch.serve import retrieval as tret


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAX_BUF = 512
ULP_TOL = 2

SPECS = {
    "version": jcoll.SyntheticSpec("version", n_base=3, n_variants=7, base_len=90,
                                   mutation_rate=0.01, seed=5),
    "paperlike-dna-p001": jcoll.paperlike_collections(0.3)["dna-p001"],
}


def _fields(obj):
    """Field dict of a reference index object, arrays as numpy."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _fields(v)
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module", params=list(SPECS))
def services(request):
    coll = jcoll.generate(SPECS[request.param])
    jsvc = JService.build(coll, block_size=16, beta=8.0, validate=False)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    built = tret.RetrievalService.build(tcoll, block_size=16, beta=8.0, device="cpu")
    carried = convert.service_from_numpy(
        tcoll, csa=_fields(jsvc.csa), ilcp=_fields(jsvc.ilcp), sada=_fields(jsvc.sada),
        pdl_list=_fields(jsvc.pdl_list), pdl_topk=_fields(jsvc.pdl_topk),
        da=np.asarray(jsvc.da), device="cpu",
    )
    pats = jcoll.random_substring_patterns(coll, 300, 5, 24)
    assert len(pats) >= 17
    # the reference's answers, computed once per request and shared by
    # the built and the carried port services
    return jsvc, {"built": built, "carried": carried}, pats, {}


def _ref(cache, key, fn):
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def _edge_batch(pats, sigma):
    return [pats[0], np.zeros(0, np.int32), np.full(tret.MAX_PATTERN_LEN + 1, 1, np.int32),
            np.array([1, sigma, 2], np.int32), pats[1], np.array([-1], np.int32)]


def _ranges(jsvc, pats):
    plan = jsvc.plan(pats)
    return plan["lo"], plan["hi"]


# ---------------------------------------------------------------------------
# PDL in both modes: arrays, per-range (doc, tf) lists, top-k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["list", "topk"])
def test_pdl_arrays_match_reference(services, mode):
    """The port's build, field by field: the top-k PDL (beta=None, with
    frequency runs) and the listing PDL, which stays as it was."""
    jsvc, ports, _, _ = services
    ref = jsvc.pdl_topk if mode == "topk" else jsvc.pdl_list
    got = ports["built"].pdl_topk if mode == "topk" else ports["built"].pdl_list
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        if hasattr(want, "shape"):
            _same(want, getattr(got, f.name))
        else:
            assert getattr(got, f.name) == want, f.name
    assert got.modeled_bits() == ref.modeled_bits()
    assert got.has_freqs == (mode == "topk")


@pytest.mark.parametrize("max_buf", [8, MAX_BUF])
def test_pdl_doc_freqs_and_topk_batch(services, max_buf):
    jsvc, ports, pats, _ = services
    lo, hi = _ranges(jsvc, pats)
    lo = np.concatenate([lo, [0, 5, 0]]).astype(np.int32)   # + empty and everything
    hi = np.concatenate([hi, [0, 5, jsvc.coll.n]]).astype(np.int32)
    svc = ports["built"]
    want = jpdl.pdl_doc_freqs_batch(jsvc.pdl_topk, jsvc.csa, jnp.asarray(lo), jnp.asarray(hi),
                                    max_buf=max_buf)
    got = tpdl.pdl_doc_freqs_batch(svc.pdl_topk, svc.csa, _t(lo), _t(hi), max_buf=max_buf)
    for w, g in zip(want, got):
        _same(w, g)
    for k in (1, 5):
        want = jpdl.pdl_topk_batch(jsvc.pdl_topk, jsvc.csa, jnp.asarray(lo), jnp.asarray(hi),
                                   k, max_buf=max_buf)
        got = tpdl.pdl_topk_batch(svc.pdl_topk, svc.csa, _t(lo), _t(hi), k, max_buf=max_buf)
        for w, g in zip(want, got):
            _same(w, g)


@pytest.mark.parametrize("k", [1, 10, 64])
def test_brute_topk_batch(services, k):
    jsvc, ports, pats, _ = services
    lo, hi = _ranges(jsvc, pats)
    max_df = 16  # below some queries' df: rows truncate before ranking
    docs, cnt, freqs = jlisting.brute_list_csa_batch(jsvc.csa, jnp.asarray(lo), jnp.asarray(hi),
                                                     128, max_df)
    want = jlisting.brute_topk_batch(docs, cnt, freqs, k)
    got = tlisting.brute_topk_batch(_t(docs), _t(cnt), _t(freqs), k)
    for w, g in zip(want, got):
        _same(w, g)
    # the port's own window gives the same rows
    tdocs, tcnt, tfreqs = tlisting.brute_list_csa_batch(ports["built"].csa, _t(lo), _t(hi),
                                                        128, max_df)
    for w, g in zip(want, tlisting.brute_topk_batch(tdocs, tcnt, tfreqs, k)):
        _same(w, g)


def test_brute_topk_orders_ties_by_id():
    docs = np.array([[9, 4, 7, 2, -1], [3, 1, 2, -1, -1]], np.int32)
    freqs = np.array([[2, 5, 2, 5, 0], [1, 1, 1, 0, 0]], np.int32)
    cnt = np.array([4, 3], np.int32)
    d, f = tlisting.brute_topk_batch(_t(docs), _t(cnt), _t(freqs), 4)
    assert d.tolist() == [[2, 4, 7, 9], [1, 2, 3, -1]]
    assert f.tolist() == [[5, 5, 2, 2], [1, 1, 1, 0]]


# ---------------------------------------------------------------------------
# tf-idf pieces
# ---------------------------------------------------------------------------


def _ulps(a, b):
    """ulp distance of non-negative float32 arrays."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("d", [1, 21, 320, 1280])
def test_idf_weight_within_2_ulp(d):
    df = np.arange(0, d + 1, dtype=np.int32)
    want = np.asarray(jtfidf.idf_weight(d, jnp.asarray(df)))
    got = ttfidf.idf_weight(d, _t(df))
    assert got.dtype == torch.float32
    assert _ulps(want, got.numpy()).max() <= ULP_TOL


def test_rank_topk_scores_matches_reference():
    rng = np.random.default_rng(3)
    Q, M = 6, 40
    docs = rng.permutation(np.arange(Q * M)).reshape(Q, M).astype(np.int32)
    scores = rng.integers(0, 4, (Q, M)).astype(np.float32) * np.float32(0.75)  # many ties
    ok = rng.random((Q, M)) < 0.8
    ok[0] = False
    docs = np.where(ok, docs, np.iinfo(np.int32).max).astype(np.int32)
    for k in (1, 10):
        got = ttfidf.rank_topk_scores(_t(docs), _t(scores), _t(ok), k)
        for q in range(Q):
            want = jtfidf.rank_topk_scores(jnp.asarray(docs[q]), jnp.asarray(scores[q]),
                                           jnp.asarray(ok[q]), k)
            _same(want[0], got[0][q])
            _same(want[1], got[1][q])


def _term_batch(pats, sigma, rng, Q):
    """[Q, 4, m] term patterns as ``tfidf_arrays`` pads them, with absent
    slots (length 0), an out-of-alphabet term and one query of no terms."""
    m = max(len(p) for p in pats)
    P = np.zeros((Q, 4, m), np.int32)
    L = np.zeros((Q, 4), np.int32)
    for q in range(Q):
        for t in range(int(rng.integers(0, 5)) if q else 0):
            p = pats[int(rng.integers(0, len(pats)))]
            P[q, t, : len(p)] = p
            L[q, t] = len(p)
    P[1, 0, :2] = [sigma, 0]
    L[1, 0] = 2
    return P, L


def test_term_ranges_batch(services):
    jsvc, ports, pats, _ = services
    P, L = _term_batch(pats, jsvc.coll.sigma, np.random.default_rng(7), 9)
    want = jtfidf.term_ranges_batch(jsvc.csa, jnp.asarray(P), jnp.asarray(L))
    for svc in ports.values():
        got = ttfidf.term_ranges_batch(svc.csa, _t(P), _t(L))
        _same(want[0], got[0])
        _same(want[1], got[1])


@pytest.mark.parametrize("conjunctive", [False, True])
def test_tfidf_fold_is_the_references(services, conjunctive, monkeypatch):
    """With the reference's idf weights injected, the port's fold and
    ranking give the reference's documents and scores bit for bit."""
    jsvc, ports, pats, _ = services
    P, L = _term_batch(pats, jsvc.coll.sigma, np.random.default_rng(11), 12)
    ranges, valid = jtfidf.term_ranges_batch(jsvc.csa, jnp.asarray(P), jnp.asarray(L))
    want = jtfidf.tfidf_topk_batch(jsvc.pdl_topk, jsvc.csa, jsvc.sada, ranges, valid, 10,
                                   conjunctive, max_buf=MAX_BUF)
    monkeypatch.setattr(ttfidf, "idf_weight", lambda d, df: torch.from_numpy(
        np.array(jtfidf.idf_weight(d, jnp.asarray(df.numpy())))))
    svc = ports["built"]
    got = ttfidf.tfidf_topk_batch(svc.pdl_topk, svc.csa, svc.sada, _t(ranges), _t(valid), 10,
                                  conjunctive, max_buf=MAX_BUF)
    _same(want[0], got[0])
    _same(want[1], got[1])


# ---------------------------------------------------------------------------
# Endpoints
# ---------------------------------------------------------------------------


def _batches(pats, sigma):
    return {"1": pats[:1], "3": pats[1:4], "17": pats[:17], "edge": _edge_batch(pats, sigma)}


@pytest.mark.parametrize("which", ["built", "carried"])
@pytest.mark.parametrize("batch", ["1", "3", "17", "edge"])
@pytest.mark.parametrize("engine", ["auto", "brute", "ilcp", "pdl"])
def test_topk_arrays(services, which, batch, engine):
    jsvc, ports, pats, cache = services
    b = _batches(pats, jsvc.coll.sigma)[batch]
    want = _ref(cache, ("topk", batch, engine),
                lambda: jsvc.topk_arrays(b, k=10, engine=engine, max_buf=MAX_BUF))
    got = ports[which].topk_arrays(b, k=10, engine=engine, max_buf=MAX_BUF)
    _same(want[0], got[0])
    _same(want[1], got[1])


def test_topk_lists_and_truncation(services):
    """The list form, and a candidate buffer small enough to truncate the
    gather (rows then hold partial frequencies, as the reference's do)."""
    jsvc, ports, pats, _ = services
    for svc in ports.values():
        assert svc.topk(pats[:5], k=3, max_buf=MAX_BUF) == \
            jsvc.topk(pats[:5], k=3, max_buf=MAX_BUF)
        for engine in ("pdl", "brute"):
            want = jsvc.topk_arrays(pats[:17], k=10, engine=engine, max_buf=16)
            got = svc.topk_arrays(pats[:17], k=10, engine=engine, max_buf=16)
            _same(want[0], got[0])
            _same(want[1], got[1])


def _tfidf_batches(pats, sigma):
    rng = np.random.default_rng(0)
    cli = [[pats[i], pats[int(rng.integers(0, len(pats)))]] for i in range(17)]
    edge = [[pats[2]], [], pats[3:9], [np.array([1, sigma, 2], np.int32), pats[4]],
            [np.zeros(0, np.int32), pats[5]], [pats[6], pats[6]]]
    return {"cli17": cli, "edge": edge}


def assert_tfidf_close(want_docs, want_scores, got_docs, got_scores, full):
    """Scores within ``ULP_TOL`` ulp; ids exact except where two candidates'
    reference scores (``full``: doc -> score per query, all candidates)
    lie within ``ULP_TOL`` ulp of each other."""
    assert got_docs.dtype == np.int32 and got_scores.dtype == np.float32
    assert got_docs.shape == want_docs.shape
    _same(want_docs >= 0, got_docs >= 0)
    assert _ulps(want_scores, got_scores).max(initial=0) <= ULP_TOL
    for q in range(want_docs.shape[0]):
        for w, g in zip(want_docs[q], got_docs[q]):
            if w != g:
                assert _ulps(full[q][int(w)], full[q][int(g)]) <= ULP_TOL, (q, w, g)


@pytest.mark.parametrize("which", ["built", "carried"])
@pytest.mark.parametrize("batch", ["cli17", "edge"])
@pytest.mark.parametrize("conjunctive", [False, True])
@pytest.mark.parametrize("max_buf", [16, MAX_BUF])
def test_tfidf_arrays(services, which, batch, conjunctive, max_buf):
    jsvc, ports, pats, cache = services
    queries = _tfidf_batches(pats, jsvc.coll.sigma)[batch]
    k_all = jsvc.coll.d + 1

    def reference():
        want = jsvc.tfidf_arrays(queries, k=10, conjunctive=conjunctive, max_buf=max_buf)
        fd, fs = jsvc.tfidf_arrays(queries, k=k_all, conjunctive=conjunctive, max_buf=max_buf)
        full = [{int(x): s for x, s in zip(fd[q], fs[q]) if x >= 0} for q in range(len(fd))]
        return want, full

    (wd, ws), full = _ref(cache, ("tfidf", batch, conjunctive, max_buf), reference)
    gd, gs = ports[which].tfidf_arrays(queries, k=10, conjunctive=conjunctive, max_buf=max_buf)
    assert_tfidf_close(wd, ws, gd, gs, full)


def test_tfidf_lists(services):
    jsvc, ports, pats, _ = services
    queries = _tfidf_batches(pats, jsvc.coll.sigma)["cli17"][:4]
    for svc in ports.values():
        want = jsvc.tfidf(queries, k=5, max_buf=MAX_BUF)
        got = svc.tfidf(queries, k=5, max_buf=MAX_BUF)
        assert [len(r) for r in got] == [len(r) for r in want]
        for wr, gr in zip(want, got):
            assert all(isinstance(d, int) and isinstance(s, float) for d, s in gr)
            assert _ulps([s for _, s in wr], [s for _, s in gr]).max(initial=0) <= ULP_TOL


def test_empty_batches_and_missing_index(services):
    jsvc, ports, pats, _ = services
    for svc in ports.values():
        d, t = svc.topk_arrays([], k=7)
        assert d.shape == t.shape == (0, 7) and d.dtype == t.dtype == np.int32
        assert svc.topk([], k=7) == []
        d, s = svc.tfidf_arrays([], k=7)
        assert d.shape == s.shape == (0, 7) and s.dtype == np.float32
        assert svc.tfidf([], k=7) == []
    bare = dataclasses.replace(ports["built"], pdl_topk=None)
    with pytest.raises(ValueError, match="pdl_topk"):
        bare.topk_arrays(pats[:2])
    with pytest.raises(ValueError, match="pdl_topk"):
        bare.tfidf_arrays([pats[:2]])
    assert "pdl_topk_bpc" not in bare.space_report()
    assert ports["built"].space_report()["pdl_topk_bpc"] == jsvc.space_report()["pdl_topk_bpc"]


def test_topk_build_is_timed_and_optional(services):
    jsvc, ports, pats, _ = services
    assert set(ports["built"].build_seconds) == {"suffix", "csa", "ilcp", "pdl", "pdl_topk",
                                                 "sada", "validate"}
    coll = jsvc.coll
    bare = tret.RetrievalService.build(
        Collection(text=coll.text, doc_starts=coll.doc_starts, doc_ends=coll.doc_ends,
                   d=coll.d, sigma=coll.sigma),
        block_size=16, beta=8.0, topk_index=False, device="cpu")
    assert bare.pdl_topk is None and "pdl_topk" not in bare.build_seconds
    _same(jsvc.list_docs_arrays(pats[:5], max_df=8)[0], bare.list_docs_arrays(pats[:5], max_df=8)[0])
    with pytest.raises(ValueError, match="pdl_topk"):
        bare.topk(pats[:2])


def test_pdl_topk_build_from_suffix_data():
    """``build_pdl(mode="topk")`` on the port's own suffix data, at a block
    size that leaves the whole collection one leaf, and an unknown mode."""
    coll = jcoll.generate(SPECS["version"])
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    data = build_suffix_data(tcoll, "cpu")
    one = tpdl.build_pdl(data, block_size=coll.n, beta=None, mode="topk")
    assert (one.L, one.I) == (1, 0)
    counts = np.bincount(data.da.numpy(), minlength=coll.d)
    assert int(one.freq_gcum[-1]) == one.total_docs_stored == np.count_nonzero(counts)
    with pytest.raises(ValueError, match="mode"):
        tpdl.build_pdl(data, mode="rank")
