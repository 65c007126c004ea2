"""The per-query reference engine, ``count_ilcp``, the single-query
primitives behind them, and the ``repro_torch.launch.serve`` CLI, against
the reference package.

Both packages build one seeded collection (the reference runtime tests'
``version`` collection).  ``engine="reference"`` and every
``"reference:<engine>"`` must equal the reference's reference engine and
the port's batched engine bit for bit (tf-idf scores within 2 ulp, the
idf weights' library difference); the single-query functions, each the
port's batch function over a batch of one, must give the reference's
integers, dtype included.
"""

import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import csa as jcsa
from repro.core import ilcp as jilcp
from repro.core import listing as jlisting
from repro.core import pdl as jpdl
from repro.core import sada as jsada
from repro.data import collections as jcoll
from repro.launch import serve as jlaunch
from repro.serve.retrieval import RetrievalService as JService
from repro.succinct import wavelet as jwavelet
from repro_torch.core import csa as tcsa
from repro_torch.core import ilcp as tilcp
from repro_torch.core import listing as tlisting
from repro_torch.core import pdl as tpdl
from repro_torch.core import sada as tsada
from repro_torch.core.suffix import Collection
from repro_torch.data import collections as tcoll
from repro_torch.launch import serve as tlaunch
from repro_torch.serve.retrieval import RetrievalService as TService
from repro_torch.succinct import wavelet as twavelet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ULP_TOL = 2

# the reference's single-query functions, compiled once per static shape
# (run eagerly, each of their loops would compile anew on every call)
J_WM_COUNT_LESS = jax.jit(jax.vmap(jwavelet.wm_count_less, in_axes=(None, 0, 0, 0)))
J_ILCP_COUNT = jax.jit(jilcp.ilcp_count_docs_batch)
J_SADA_COUNT = jax.jit(jsada.sada_count)
J_BRUTE_LIST = jax.jit(jlisting.brute_list_csa, static_argnames=("max_occ", "max_df"))
J_BRUTE_TOPK = jax.jit(jlisting.brute_topk, static_argnames=("k",))
J_ILCP_LIST = jax.jit(jilcp.ilcp_list_docs_da, static_argnames=("max_df",))
J_PDL_LIST = jax.jit(jpdl.pdl_list_docs, static_argnames=("max_df", "max_buf", "max_cover"))
J_PDL_FREQS = jax.jit(jpdl.pdl_doc_freqs, static_argnames=("max_buf", "max_cover"))
J_PDL_TOPK = jax.jit(jpdl.pdl_topk, static_argnames=("k", "max_buf", "max_cover"))
SPEC = dict(family="version", n_base=2, n_variants=6, base_len=80, mutation_rate=0.01, seed=3)


@pytest.fixture(scope="module")
def svcs():
    coll = jcoll.generate(jcoll.SyntheticSpec(**SPEC))
    jsvc = JService.build(coll, block_size=16, beta=8.0, validate=False)
    tc = Collection(text=coll.text, doc_starts=coll.doc_starts,
                    doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tsvc = TService.build(tc, block_size=16, beta=8.0, device="cpu")
    # 16 patterns of length 4 (Brute-L under auto), 4 of length 2 (PDL),
    # then soft-invalid inputs: empty, out-of-alphabet, too long
    pats = jcoll.random_substring_patterns(coll, 200, 4, 16)
    pats += jcoll.random_substring_patterns(coll, 200, 2, 4)
    assert len(pats) == 20
    edge = [np.zeros(0, np.int32), np.array([1, coll.sigma, 2], np.int32),
            np.full(5000, 1, np.int32)]
    return jsvc, tsvc, list(pats) + edge


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---------------------------------------------------------------------------
# The reference engine and count_ilcp
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_answers(svcs):
    """The reference's per-query engine on two patterns of each auto
    engine (Brute-L and PDL) and the edge inputs (it runs eagerly, about a second a
    query): list_docs (max_buf 8, so windows and buffers truncate) and
    topk (k = 3) per engine."""
    jsvc, tsvc, pats = svcs
    engines = tsvc.plan(pats[:20])["engine"].tolist()
    pick = [i for i, e in enumerate(engines) if e == 1][:2] + \
        [i for i, e in enumerate(engines) if e == 3][:2]
    assert len(pick) == 4, engines
    few = [pats[i] for i in pick] + pats[20:]
    lists = {e: jsvc.list_docs(few, max_df=32, engine=e, max_buf=8)
             for e in ("reference", "reference:ilcp", "reference:pdl")}
    topks = {e: jsvc.topk(few, k=3, engine=e, max_buf=512)
             for e in ("reference", "reference:pdl")}
    return few, lists, topks


@pytest.mark.parametrize("engine", ["reference", "reference:ilcp", "reference:pdl"])
def test_list_docs_reference_matches_references(svcs, reference_answers, engine):
    _, tsvc, _ = svcs
    few, lists, _ = reference_answers
    assert tsvc.list_docs(few, max_df=32, engine=engine, max_buf=8) == lists[engine]


@pytest.mark.parametrize("engine", ["reference", "reference:pdl"])
def test_topk_reference_matches_references(svcs, reference_answers, engine):
    _, tsvc, _ = svcs
    few, _, topks = reference_answers
    assert tsvc.topk(few, k=3, engine=engine, max_buf=512) == topks[engine]


@pytest.mark.parametrize("engine", ["reference", "reference:auto", "reference:brute",
                                    "reference:ilcp", "reference:pdl"])
@pytest.mark.parametrize("max_buf", [4096, 8])
def test_list_docs_reference_matches_batched(svcs, engine, max_buf):
    _, tsvc, pats = svcs
    sub = engine.partition(":")[2] or "auto"
    assert tsvc.list_docs(pats, max_df=32, engine=engine, max_buf=max_buf) == \
        tsvc.list_docs(pats, max_df=32, engine=sub, max_buf=max_buf)


@pytest.mark.parametrize("engine", ["reference", "reference:brute", "reference:ilcp",
                                    "reference:pdl"])
@pytest.mark.parametrize("k", [1, 3, 40])
def test_topk_reference_matches_batched(svcs, engine, k):
    _, tsvc, pats = svcs
    sub = engine.partition(":")[2] or "auto"
    assert tsvc.topk(pats, k=k, engine=engine, max_buf=512) == \
        tsvc.topk(pats, k=k, engine=sub, max_buf=512)


def test_count_reference_and_count_ilcp(svcs):
    jsvc, tsvc, pats = svcs
    got = tsvc.count(pats, engine="reference")
    _same(got, jsvc.count(pats, engine="reference"))
    _same(got, tsvc.count(pats))
    _same(tsvc.count_ilcp(pats), jsvc.count_ilcp(pats))
    _same(tsvc.count_ilcp(pats), got)


@pytest.mark.parametrize("conjunctive", [False, True])
def test_tfidf_reference(svcs, conjunctive):
    jsvc, tsvc, pats = svcs
    # (the reference's per-query search takes no batch of empty patterns
    # only: a query whose every term normalizes to empty is left out)
    queries = [[pats[i], pats[i + 16]] for i in range(3)] + [[pats[3]], [],
                                                            [pats[2], pats[21]]]
    got = tsvc.tfidf(queries, k=4, conjunctive=conjunctive, engine="reference")
    want = jsvc.tfidf(queries, k=4, conjunctive=conjunctive, engine="reference")
    batched = tsvc.tfidf(queries, k=4, conjunctive=conjunctive)
    for q, (w, g) in enumerate(zip(want, got)):
        assert len(w) == len(g)
        for (wd, ws), (gd, gs) in zip(w, g):
            assert _ulps(ws, gs) <= ULP_TOL
            if wd != gd:        # a swap inside a 2-ulp tie
                full = dict(jsvc.tfidf([queries[q]], k=jsvc.coll.d + 1,
                                       conjunctive=conjunctive, engine="reference")[0])
                assert _ulps(full[wd], full[gd]) <= ULP_TOL
    # against the port's own batched engine: the same function, bit for bit
    # (an empty term is invalid in the batched program and valid-but-empty
    # in the per-query one, which only ranked-AND can tell apart)
    for q in range(4):
        assert got[q] == batched[q]


def test_all_empty_batch_divergence(svcs):
    """Known divergence (ROADMAP, queue C): the reference's per-query range
    pass raises on a batch whose every pattern normalizes to empty (its
    backward search over a zero-width batch); the port searches one padded
    column and answers empty."""
    jsvc, tsvc, pats = svcs
    empty = [pats[20], pats[21]]
    with pytest.raises(IndexError):
        jsvc.count(empty, engine="reference")
    _same(tsvc.count(empty, engine="reference"), np.zeros(2, np.int32))
    assert tsvc.list_docs(empty, engine="reference") == [[], []]
    assert tsvc.tfidf([[pats[21]]], engine="reference") == [[]]


def test_reference_engine_empty_batches(svcs):
    _, tsvc, _ = svcs
    assert tsvc.list_docs([], engine="reference") == []
    assert tsvc.topk([], engine="reference") == []
    assert tsvc.tfidf([], engine="reference") == []
    assert tsvc.count([], engine="reference").shape == (0,)


# ---------------------------------------------------------------------------
# Single-query primitives
# ---------------------------------------------------------------------------


def _ranges(jsvc, pats, n, seed=0):
    """Planned ranges and their pattern lengths, then edge and random
    ranges (length 3)."""
    p = jsvc.plan(pats)
    lens = [len(x) for x in jcoll.normalize_patterns(pats, sigma=jsvc.coll.sigma,
                                                      max_len=4096)]
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, n, 12)
    hi = np.minimum(n, lo + rng.integers(0, 40, 12))
    out = list(zip(p["lo"].tolist(), p["hi"].tolist(), lens))
    out += [(0, 0, 3), (0, n, 3), (n - 5, n, 3), (7, 7, 3)]
    out += [(int(a), int(b), 3) for a, b in zip(lo, hi)]
    return out


def test_csa_search_batch(svcs):
    jsvc, tsvc, pats = svcs
    norm = jcoll.normalize_patterns(pats, sigma=jsvc.coll.sigma, max_len=4096)
    p, lens = jcoll.pad_patterns(norm)
    want = jcsa.csa_search_batch(jsvc.csa, jnp.asarray(p), jnp.asarray(lens))
    got = tcsa.csa_search_batch(tsvc.csa, _t(p), _t(lens))
    for g, w in zip(got, want):
        _same(g, w)


def test_wm_count_less(svcs):
    jsvc, tsvc, _ = svcs
    rng = np.random.default_rng(1)
    for jwm, twm in ((jsvc.csa.wm, tsvc.csa.wm), (jsvc.ilcp.wm, tsvc.ilcp.wm)):
        lo = rng.integers(0, twm.n + 1, 64).astype(np.int32)
        hi = np.minimum(twm.n, lo + rng.integers(0, 50, 64)).astype(np.int32)
        m = rng.integers(0, twm.sigma + 3, 64).astype(np.int32)
        got = twavelet.wm_count_less(twm, _t(lo), _t(hi), _t(m))
        _same(got, J_WM_COUNT_LESS(jwm, lo, hi, m))


def test_ilcp_count_docs(svcs):
    jsvc, tsvc, pats = svcs
    rs = _ranges(jsvc, pats, tsvc.coll.n)
    rs += [(a, b, 60) for a, b, _ in rs[:6]]        # m past max_value
    lo, hi, m = (np.asarray(x, np.int32) for x in zip(*rs))
    want = J_ILCP_COUNT(jsvc.ilcp, lo, hi, m)
    _same(tilcp.ilcp_count_docs_batch(tsvc.ilcp, _t(lo), _t(hi), _t(m)), want)
    for i in (0, 3, len(rs) - 1):
        _same(tilcp.ilcp_count_docs(tsvc.ilcp, int(lo[i]), int(hi[i]), int(m[i])), want[i])
    _same(tilcp.ilcp_count_docs_batch(tsvc.ilcp, _t(lo[:0]), _t(hi[:0]), _t(m[:0])),
          np.zeros(0, np.int32))


def test_sada_count(svcs):
    jsvc, tsvc, pats = svcs
    for a, b, _ in _ranges(jsvc, pats, tsvc.coll.n):
        _same(tsada.sada_count(tsvc.sada, a, b),
              J_SADA_COUNT(jsvc.sada, jnp.int32(a), jnp.int32(b)))


@pytest.mark.parametrize("max_df", [None, 4])
def test_brute_list_csa_and_topk(svcs, max_df):
    jsvc, tsvc, pats = svcs
    for a, b, _ in _ranges(jsvc, pats, tsvc.coll.n):
        got = tlisting.brute_list_csa(tsvc.csa, a, b, 64, max_df)
        want = J_BRUTE_LIST(jsvc.csa, jnp.int32(a), jnp.int32(b), max_occ=64, max_df=max_df)
        for g, w in zip(got, want):
            _same(g, w)
        for k in (1, 3, 70):
            for g, w in zip(tlisting.brute_topk(*got, k), J_BRUTE_TOPK(*want, k=k)):
                _same(g, w)


@pytest.mark.parametrize("max_df", [2, 32])
def test_ilcp_list_docs_da(svcs, max_df):
    jsvc, tsvc, pats = svcs
    for a, b, _ in _ranges(jsvc, pats, tsvc.coll.n):
        got = tilcp.ilcp_list_docs_da(tsvc.ilcp, tsvc.da, a, b, max_df)
        want = J_ILCP_LIST(jsvc.ilcp, jsvc.da, jnp.int32(a), jnp.int32(b), max_df=max_df)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("which", ["pdl_list", "pdl_topk"])
def test_pdl_single_query(svcs, which):
    jsvc, tsvc, pats = svcs
    jp, tp = getattr(jsvc, which), getattr(tsvc, which)
    for a, b, _ in _ranges(jsvc, pats, tsvc.coll.n)[::2]:
        ja, jb = jnp.int32(a), jnp.int32(b)
        for g, w in zip(tpdl.pdl_list_docs(tp, tsvc.csa, a, b, 16, max_buf=64),
                        J_PDL_LIST(jp, jsvc.csa, ja, jb, max_df=16, max_buf=64)):
            _same(g, w)
        for g, w in zip(tpdl.pdl_doc_freqs(tp, tsvc.csa, a, b, max_buf=64, max_cover=4),
                        J_PDL_FREQS(jp, jsvc.csa, ja, jb, max_buf=64, max_cover=4)):
            _same(g, w)
        for g, w in zip(tpdl.pdl_topk(tp, tsvc.csa, a, b, 3, max_buf=64),
                        J_PDL_TOPK(jp, jsvc.csa, ja, jb, k=3, max_buf=64)):
            _same(g, w)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _tiny(spec_cls):
    def collections(scale: float = 1.0, seed: int = 0):
        return {"version-p001": spec_cls("version", n_base=3, n_variants=4, base_len=60,
                                         mutation_rate=0.01, seed=seed)}
    return collections


def _run_cli(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out.splitlines()


_TIMES = re.compile(r"\d+\.\d+(?=s|ms)|\(\d+ q/s\)")


@pytest.mark.parametrize("argv", [
    ["--mode", "topk", "--queries", "48", "--batch", "16", "--deadline-ms", "1e6"],
    ["--mode", "list", "--queries", "32", "--batch", "8", "--deadline-ms", "1e6",
     "--inject", "executor_fail:0.3,slow_list"],
], ids=["topk", "list-injected"])
def test_serve_cli_prints_the_references_lines(monkeypatch, capsys, argv):
    """``python -m repro_torch.launch.serve --device cpu`` on a tiny corpus
    prints the reference launcher's lines: the same corpus, fingerprint
    names, space report, compile buckets and resilience counters; only the
    timings differ.  The tracer's table follows them."""
    monkeypatch.setattr(jlaunch, "paperlike_collections", _tiny(jcoll.SyntheticSpec))
    monkeypatch.setattr(tlaunch, "paperlike_collections", _tiny(tcoll.SyntheticSpec))

    def ref_main(args):
        monkeypatch.setattr(sys, "argv", ["serve"] + args)
        jlaunch.main()

    want = _run_cli(ref_main, argv, capsys)
    got = _run_cli(tlaunch.main, argv + ["--device", "cpu"], capsys)
    got, table = got[:14], got[14:]
    assert table[0].startswith("span or counter")
    assert {line.split()[0] for line in table[1:]} >= {"runtime.batch", "service.replay",
                                                       "device.plan"}
    assert len(got) == len(want) == 14
    assert [_TIMES.sub("T", x) for x in got] == [_TIMES.sub("T", x) for x in want]
    assert "integrity validated: csa, da, ilcp, pdl_list, pdl_topk, sada" in got[0]
    assert got[-1].startswith("resilience: ")
    if "--inject" not in argv:
        assert "degraded_fraction=0.000" in got[-1] and "retries=0" in got[-1]
