"""The port's last tf-idf functions and single-query helpers against the
reference's.

* ``tfidf_topk_incremental``, the paper's k' doubling loop (Section 6.5):
  its weights are float64 ``np.log2`` on the host in both packages, so its
  documents and scores must be exactly the reference's on the same ranges.
* The single-query ``tfidf_topk``: the batched engine over a batch of
  one, held as the batched endpoint is (scores within the 2 ulp of
  ROADMAP C4, documents exact but for ties within them).
* ``encode_pattern``, ``naive_suffix_array``, ``naive_lcp_of``,
  ``wm_rank_pair`` and ``wm_symbol_range``.

The reference's single-query functions run eagerly, op by op, which takes
about a second a call here.  So they run here under ``jax.jit`` (the
incremental loop's per-term ``pdl_topk`` and ``sada_count``, and the
single-query ``tfidf_topk``, one trace per term count), and the wavelet
functions under ``jax.vmap`` over every case at once.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import suffix as jsuffix
from repro.core import tfidf as jtfidf
from repro.data.collections import SyntheticSpec, generate, random_substring_patterns
from repro.serve.retrieval import RetrievalService as JService
from repro.succinct import wavelet as jwavelet
from repro_torch.core import suffix as tsuffix
from repro_torch.core import tfidf as ttfidf
from repro_torch.kernels import pdl_gather as kpdl
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
MAX_BUF = 512


@pytest.fixture(scope="module")
def sides():
    mp = pytest.MonkeyPatch()
    mp.setattr(jtfidf, "pdl_topk", jax.jit(jtfidf.pdl_topk, static_argnums=(4,)))
    mp.setattr(jtfidf, "sada_count", jax.jit(jtfidf.sada_count))
    yield _sides()
    mp.undo()


def _sides():
    coll = generate(SyntheticSpec("version", n_base=3, n_variants=7, base_len=90,
                                  mutation_rate=0.01, seed=5))
    jsvc = JService.build(coll, block_size=16, beta=8.0, validate=False)
    tcoll = tsuffix.Collection(text=coll.text, doc_starts=coll.doc_starts,
                               doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tsvc = TService.build(tcoll, block_size=16, beta=8.0, validate=False, device="cpu")
    pats = random_substring_patterns(coll, 24, 3, 14)
    plan = tsvc.plan(pats)
    ranges = np.stack([plan["lo"], plan["hi"]], axis=1)
    want = jsvc.plan(pats)
    np.testing.assert_array_equal(ranges, np.stack([want["lo"], want["hi"]], axis=1))
    # queries of one, two and three terms, an empty range among them
    empty = np.asarray([[0, 0]], np.int32)
    queries = ([ranges[i:i + 2] for i in range(0, 8, 2)]
               + [ranges[12:13], ranges[:3], np.concatenate([ranges[5:6], empty])])
    return jsvc, tsvc, queries


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("conjunctive", [False, True])
@pytest.mark.parametrize("k", [1, 3, 10])
def test_incremental_is_the_references(sides, conjunctive, k):
    jsvc, tsvc, queries = sides
    for q in queries:
        want = jtfidf.tfidf_topk_incremental(jsvc.pdl_topk, jsvc.csa, jsvc.sada, q, k,
                                             conjunctive, max_buf=MAX_BUF)
        before = kpdl.pdl_gather.launches
        got = ttfidf.tfidf_topk_incremental(tsvc.pdl_topk, tsvc.csa, tsvc.sada, q, k,
                                            conjunctive, max_buf=MAX_BUF)
        assert kpdl.pdl_gather.launches == before  # CPU tensors: the plain gather
        assert got == want
        assert all(type(w) is float for w in got[1])


def test_incremental_gathers_once_per_term(sides, monkeypatch):
    """One ``pdl_topk`` extraction, that is one PDL gather, per term."""
    _, tsvc, queries = sides
    calls = []
    real = ttfidf.pdl_topk

    def counted(*args, **kw):
        calls.append(args[2:4])
        return real(*args, **kw)

    monkeypatch.setattr(ttfidf, "pdl_topk", counted)
    for q in queries:
        calls.clear()
        ttfidf.tfidf_topk_incremental(tsvc.pdl_topk, tsvc.csa, tsvc.sada, q, 3, False,
                                      max_buf=MAX_BUF)
        assert calls == [(int(lo), int(hi)) for lo, hi in q]


_jit_tfidf_topk = functools.partial(
    jax.jit, static_argnames=("k", "conjunctive", "max_buf"))(jtfidf.tfidf_topk)


@pytest.mark.parametrize("conjunctive", [False, True])
def test_single_query_tfidf_topk(sides, conjunctive):
    jsvc, tsvc, queries = sides
    k = jsvc.coll.d  # every candidate: a swap of two near-ties stays visible
    for q in queries:
        if len(q) != 2:
            continue  # one trace per term count
        valid = np.asarray([True, q[1, 0] < q[1, 1]])  # an absent last slot
        wd, ws = (np.asarray(x) for x in _jit_tfidf_topk(
            jsvc.pdl_topk, jsvc.csa, jsvc.sada, jnp.asarray(q), jnp.asarray(valid), k=k,
            conjunctive=conjunctive, max_buf=MAX_BUF))
        gd, gs = ttfidf.tfidf_topk(tsvc.pdl_topk, tsvc.csa, tsvc.sada, q, valid, k,
                                   conjunctive, max_buf=MAX_BUF)
        gd, gs = gd.numpy(), gs.numpy()
        assert gd.dtype == np.int32 and gs.dtype == np.float32 and gd.shape == (k,)
        np.testing.assert_array_equal(wd >= 0, gd >= 0)
        assert _ulps(ws, gs).max(initial=0) <= ULP_TOL
        full = {int(x): s for x, s in zip(wd, ws) if x >= 0}
        for w, g in zip(wd, gd):
            if w != g:  # two documents whose scores tie within 2 ulp
                assert _ulps(full[int(w)], full[int(g)]) <= ULP_TOL, (w, g)


def test_single_query_with_injected_global_statistics(sides):
    """``dfs`` and ``n_docs`` override the weights, as the sharded engine
    injects them: the scores are those of the given weights."""
    jsvc, tsvc, queries = sides
    q = queries[0]
    dfs = np.asarray([3, 7], np.int32)
    wd, ws = (np.asarray(x) for x in _jit_tfidf_topk(
        jsvc.pdl_topk, jsvc.csa, jsvc.sada, jnp.asarray(q), jnp.ones(2, bool), k=10,
        conjunctive=False, max_buf=MAX_BUF, dfs=jnp.asarray(dfs), n_docs=40))
    gd, gs = ttfidf.tfidf_topk(tsvc.pdl_topk, tsvc.csa, tsvc.sada, q, np.ones(2, bool), 10,
                               False, max_buf=MAX_BUF, dfs=dfs, n_docs=40)
    np.testing.assert_array_equal(wd, gd.numpy())
    assert _ulps(ws, gs.numpy()).max(initial=0) <= ULP_TOL
    base = ttfidf.tfidf_topk(tsvc.pdl_topk, tsvc.csa, tsvc.sada, q, np.ones(2, bool), 10,
                             False, max_buf=MAX_BUF)
    assert not np.array_equal(base[1].numpy(), gs.numpy())


@pytest.mark.parametrize("pattern", ["acgt", "", "é~", [0, 3, 255], np.arange(5)])
def test_encode_pattern(pattern):
    want = jsuffix.encode_pattern(pattern)
    got = tsuffix.encode_pattern(pattern)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("docs", [["abcab", "bca"], ["banana", "ananas", "nab"], ["a"]])
def test_naive_oracles(docs):
    jc = jsuffix.concat_documents(docs)
    tc = tsuffix.concat_documents(docs)
    want = jsuffix.naive_suffix_array(jc)
    got = tsuffix.naive_suffix_array(tc)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(got, tsuffix.build_suffix_data(tc, "cpu").sa.numpy())
    for a in range(tc.n):
        for b in range(tc.n):
            assert tsuffix.naive_lcp_of(tc, a, b) == jsuffix.naive_lcp_of(jc, a, b)


def test_wm_rank_pair_and_symbol_range(sides):
    jsvc, tsvc, _ = sides
    jwm, twm = jsvc.csa.wm, tsvc.csa.wm
    rng = np.random.default_rng(5)
    n = twm.n
    cases = [(c, 0, n) for c in range(twm.sigma)] + [(0, 0, 0), (1, n, n)]
    cases += [(int(c), *sorted(int(x) for x in rng.integers(0, n + 1, 2)))
              for c in rng.integers(0, twm.sigma, 40)]
    c, lo, hi = (jnp.asarray(np.asarray(x, np.int32)) for x in zip(*cases))
    pairs, ranges = (np.stack([np.asarray(x) for x in jax.vmap(
        lambda c, lo, hi, f=f: f(jwm, c, lo, hi))(c, lo, hi)], 1)
        for f in (jwavelet.wm_rank_pair, jwavelet.wm_symbol_range))
    for case, pair, rng_ in zip(cases, pairs, ranges):
        got = twavelet.wm_rank_pair(twm, *case)
        assert all(g.dtype == torch.int32 and g.dim() == 0 for g in got)
        assert [int(x) for x in got] == pair.tolist()
        assert [int(x) for x in twavelet.wm_symbol_range(twm, *case)] == rng_.tolist()
