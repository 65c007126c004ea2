"""The port's shape-bucketed program cache against the reference's
compile cache.

On CPU tensors a program is the eager function, cached and tallied per
(kind, statics) bucket exactly as the card caches its CUDA graphs, so
``compile_counts`` is comparable here step for step with the JAX
service's.  The call sequence is the reference's own
(``tests/test_serve_batched.py::test_one_compile_per_bucket``), with the
Brute-L window pinned and again with the automatic window.  Answers must
equal the reference's: integers exactly, tf-idf scores within 2 ulp and
ids exactly outside 2-ulp ties (the idf weights' library difference,
``tests/test_torch_topk_tfidf.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data.collections import SyntheticSpec, generate, random_substring_patterns
from repro.serve import planner as jplanner
from repro.serve.retrieval import RetrievalService as JService
from repro_torch.common import IDX
from repro_torch.core.csa import csa_search_planned
from repro_torch.core.sada import sada_count_batch
from repro_torch.core.suffix import Collection
from repro_torch.serve import planner as tplanner
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
SPEC = SyntheticSpec("version", n_base=2, n_variants=5, base_len=80,
                     mutation_rate=0.01, seed=11)


@pytest.fixture(scope="module")
def coll_pats():
    coll = generate(SPEC)
    pats = random_substring_patterns(coll, 200, 5, 16)
    assert len(pats) >= 16
    return coll, pats


def _services(coll, brute_window):
    jsvc = JService.build(coll, block_size=16, beta=8.0, brute_window=brute_window,
                          validate=False)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tsvc = tret.RetrievalService.build(tcoll, block_size=16, beta=8.0,
                                       brute_window=brute_window, device="cpu")
    return jsvc, tsvc


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _reference_sequence(pats):
    """The reference test's calls, then plan and count: (endpoint, args,
    keyword arguments)."""
    steps = [("list_docs", pats[:5], {}), ("list_docs", pats[:7], {}),
             ("list_docs", pats[:5], {"engine": "pdl"}),
             ("list_docs", pats[:9], {}), ("list_docs", pats[:16], {})]
    steps += [("list_docs", pats[:7], {"engine": e}) for e in ("auto", "brute", "ilcp", "pdl")]
    steps += [("topk", pats[:5], {"k": 3}), ("topk", pats[:8], {"k": 3}),
              ("tfidf", [[pats[0], pats[1]]], {"k": 3}), ("tfidf", [[pats[2]]], {"k": 3}),
              ("plan", pats[:5], {}), ("count", pats[:16], {}), ("plan", pats[:3], {})]
    return steps


@pytest.mark.parametrize("brute_window", [MAX_BUF, None], ids=["pinned", "auto"])
def test_compile_counts_match_reference(coll_pats, brute_window):
    """After every step of the sequence the port's tally is the reference's,
    and every answer is the reference's."""
    coll, pats = coll_pats
    jsvc, tsvc = _services(coll, brute_window)
    tfidf_calls = []
    for name, arg, kw in _reference_sequence(pats):
        if name in ("list_docs", "topk", "tfidf"):
            kw = dict(kw, max_buf=MAX_BUF)
        if name == "list_docs":
            kw.setdefault("max_df", 32)
        want = getattr(jsvc, name)(arg, **kw)
        got = getattr(tsvc, name)(arg, **kw)
        if name == "tfidf":
            tfidf_calls.append((arg, kw, want, got))
        elif name == "plan":
            assert list(want) == list(got)
            for k in want:
                np.testing.assert_array_equal(want[k], got[k])
                assert want[k].dtype == got[k].dtype
        elif name == "count":
            np.testing.assert_array_equal(want, got)
        else:
            assert want == got, (name, kw)
        assert tsvc.compile_counts == jsvc.compile_counts, (name, kw)
        assert tsvc._brute_windows == jsvc._brute_windows
    assert set(tsvc.compile_counts) == (
        {"list", "topk", "tfidf", "plan"})
    assert len(tsvc.compiled_programs()) == sum(tsvc.compile_counts.values())
    # tf-idf: ranked by scores within 2 ulp of the reference's (the full
    # candidate scores, for ties, are read after the tallies are compared)
    for arg, kw, want, got in tfidf_calls:
        full = dict(jsvc.tfidf(arg, **dict(kw, k=coll.d + 1))[0])
        assert len(want) == len(got) == 1 and len(want[0]) == len(got[0])
        for (wd, ws), (gd, gs) in zip(want[0], got[0]):
            assert _ulps(ws, gs) <= ULP_TOL
            if wd != gd:
                assert _ulps(full[wd], full[gd]) <= ULP_TOL, (wd, gd)


@pytest.mark.parametrize("endpoint", ["plan", "list_docs", "topk"])
def test_engine_switch_reuses_the_program(coll_pats, endpoint):
    """auto, brute, ilcp and pdl run through one program per bucket: the
    engine is a tensor the program reads, not a static of the bucket."""
    coll, pats = coll_pats
    _, tsvc = _services(coll, MAX_BUF)
    kw = {"plan": {}, "list_docs": {"max_df": 32, "max_buf": MAX_BUF},
          "topk": {"k": 3, "max_buf": MAX_BUF}}[endpoint]
    fn = getattr(tsvc, endpoint)
    fn(pats[:7], **kw)
    programs = tsvc.compiled_programs()
    assert len(programs) == 1
    for engine in ("auto", "brute", "ilcp", "pdl", "auto"):
        fn(pats[:6], engine=engine, **kw)
    assert tsvc.compiled_programs() == programs
    assert sum(tsvc.compile_counts.values()) == 1
    engines = tsvc.plan(pats[:6], engine="ilcp")["engine"]
    assert (engines == tplanner.ENGINE_ILCP).all()


def test_cpu_program_is_the_eager_function(coll_pats):
    """On CPU tensors a program captures nothing: no graph, no launches
    recorded, and each call returns fresh tensors."""
    coll, pats = coll_pats
    _, tsvc = _services(coll, MAX_BUF)
    a = tsvc.list_docs_arrays(pats[:5], max_df=32, max_buf=MAX_BUF)
    b = tsvc.list_docs_arrays(pats[5:10], max_df=32, max_buf=MAX_BUF)
    (prog,) = tsvc.compiled_programs().values()
    assert prog.graph is None and prog.launches == {} and prog.capture_s == 0.0
    assert not np.array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[0], tsvc.list_docs_arrays(pats[:5], max_df=32,
                                                              max_buf=MAX_BUF)[0])


def test_ranges_match_reference(coll_pats):
    coll, pats = coll_pats
    jsvc, tsvc = _services(coll, MAX_BUF)
    batch = list(pats[:7]) + [np.zeros(0, np.int32), np.array([1, coll.sigma, 2], np.int32),
                              np.full(tret.MAX_PATTERN_LEN + 1, 1, np.int32)]
    for want, got in zip(jsvc.ranges(batch), tsvc.ranges(batch)):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)
    assert tsvc.compile_counts == jsvc.compile_counts == {"plan": 1}


def _plan_before(csa, sada, patterns, lengths, threshold: float, forced: int):
    """The planner as it read before the threshold and engine became
    device tensors: a host scalar and a Python branch."""
    lo, hi = csa_search_planned(csa, patterns, lengths)
    hi = torch.where(lengths > 0, hi, lo)
    occ = hi - lo
    df = sada_count_batch(sada, lo, hi)
    thresh = torch.tensor(threshold, dtype=torch.float32, device=lo.device)
    auto = torch.where(
        occ.to(torch.float32) < thresh * torch.clamp(df, min=1).to(torch.float32),
        tplanner.ENGINE_BRUTE, tplanner.ENGINE_PDL)
    engine = auto if forced < 0 else torch.full_like(lo, forced)
    engine = torch.where(occ > 0, engine, tplanner.ENGINE_EMPTY).to(IDX)
    return lo, hi, occ, df, engine


@pytest.mark.parametrize("threshold", [4.0, 1.5, 0.25])
@pytest.mark.parametrize("engine", ["auto", "brute", "ilcp", "pdl"])
def test_plan_knobs_are_exact(coll_pats, threshold, engine):
    """``plan_queries`` with the tensor threshold and engine gives the
    int32 arrays of the former host-scalar planner and of the reference's
    planner, for every forced code and for auto."""
    coll, pats = coll_pats
    jsvc, tsvc = _services(coll, MAX_BUF)
    batch = list(pats[:16]) + [np.zeros(0, np.int32), np.array([1, coll.sigma, 2], np.int32)]
    pats_t, lens_t, _ = tsvc._pad_batch(batch)
    knobs = tplanner.plan_knobs(threshold, engine, "cpu")
    assert knobs[0].dtype == torch.float32 and knobs[1].dtype == torch.int32
    assert knobs[0].dim() == knobs[1].dim() == 0
    got = tplanner.plan_queries(tsvc.csa, tsvc.sada, pats_t, lens_t, *knobs)
    code = tplanner.ENGINE_CODES[engine]
    before = _plan_before(tsvc.csa, tsvc.sada, pats_t, lens_t, threshold, code)
    ref = jplanner.plan_queries(jsvc.csa, jsvc.sada, jnp.asarray(pats_t.numpy()),
                                jnp.asarray(lens_t.numpy()), jnp.float32(threshold),
                                jnp.int32(code), use_kernel=False)
    for i, name in enumerate(("lo", "hi", "occ", "df", "engine")):
        t = getattr(got, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), before[i].numpy(), err_msg=name)
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    if engine != "auto":
        nonempty = got.occ > 0
        assert (got.engine[nonempty] == code).all()
