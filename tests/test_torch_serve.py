"""Port parity of the serving path: ``plan``, ``count`` and ``list_docs``.

Two port services stand beside the JAX ``RetrievalService`` on each
collection: one built by the port itself, and one over the reference's own
index carried across by ``repro_torch.convert``.  Both query through the
kernel wrappers, which run their plain versions on CPU tensors.  Every
endpoint must return the reference's integers, dtype included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

from repro.data import collections as jcoll
from repro.serve.retrieval import RetrievalService as JService
from repro_torch import convert
from repro_torch.core.suffix import Collection
from repro_torch.serve import retrieval as tret
from repro_torch.serve.planner import ENGINE_BRUTE, ENGINE_ILCP, ENGINE_PDL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAX_BUF = 512

SPECS = {
    "version": jcoll.SyntheticSpec("version", n_base=3, n_variants=7, base_len=90,
                                   mutation_rate=0.01, seed=5),
    "dna": jcoll.SyntheticSpec("dna", n_base=1, n_variants=16, base_len=150,
                               mutation_rate=0.003, seed=9),
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


@pytest.fixture(scope="module", params=list(SPECS))
def services(request):
    coll = jcoll.generate(SPECS[request.param])
    jsvc = JService.build(coll, block_size=16, beta=8.0, validate=False)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    built = tret.RetrievalService.build(tcoll, block_size=16, beta=8.0, device="cpu")
    carried = convert.service_from_numpy(
        tcoll, csa=_fields(jsvc.csa), ilcp=_fields(jsvc.ilcp), sada=_fields(jsvc.sada),
        pdl_list=_fields(jsvc.pdl_list), da=np.asarray(jsvc.da), device="cpu",
    )
    pats = jcoll.random_substring_patterns(coll, 300, 5, 24)
    assert len(pats) >= 17
    return jsvc, {"built": built, "carried": carried}, pats


def _edge_batch(pats, sigma):
    return [pats[0], np.zeros(0, np.int32), np.full(tret.MAX_PATTERN_LEN + 1, 1, np.int32),
            np.array([1, sigma, 2], np.int32), pats[1], np.array([-1], np.int32)]


def _batches(pats, sigma):
    return {"1": pats[:1], "3": pats[1:4], "17": pats[:17], "edge": _edge_batch(pats, sigma)}


def _same(a, b):
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["built", "carried"])
def test_pair_descent_matches_reference(services, which):
    """The port's CPU pair descent gives the reference's pair-descent
    ranges, and the same ranges as the kernel wrapper's plain version."""
    import torch
    from repro.core.csa import csa_search_planned as jsearch
    from repro_torch.core.csa import csa_search_pairs, csa_search_planned

    jsvc, ports, pats = services
    sigma = jsvc.coll.sigma
    b = list(pats[:17]) + [np.zeros(0, np.int32), np.array([1, sigma, 2], np.int32),
                           np.array([-1], np.int32)]
    p, lens = jcoll.pad_patterns(b)
    jlo, jhi = jsearch(jsvc.csa, p, lens, use_kernel=False)
    csa = ports[which].csa
    tp, tl = torch.from_numpy(p), torch.from_numpy(lens)
    for lo, hi in (csa_search_pairs(csa, tp, tl), csa_search_planned(csa, tp, tl)):
        _same(np.asarray(jlo), lo.numpy())
        _same(np.asarray(jhi), hi.numpy())


@pytest.mark.parametrize("which", ["built", "carried"])
@pytest.mark.parametrize("batch", ["1", "3", "17", "edge"])
@pytest.mark.parametrize("engine", ["auto", "brute", "ilcp", "pdl"])
def test_plan_and_count(services, which, batch, engine):
    jsvc, ports, pats = services
    b = _batches(pats, jsvc.coll.sigma)[batch]
    want = jsvc.plan(b, engine)
    got = ports[which].plan(b, engine)
    assert list(want) == list(got)
    for k in want:
        _same(want[k], got[k])
    _same(jsvc.count(b), ports[which].count(b))


@pytest.mark.parametrize("which", ["built", "carried"])
@pytest.mark.parametrize("batch", ["1", "3", "17", "edge"])
@pytest.mark.parametrize("engine", ["auto", "brute", "ilcp", "pdl"])
def test_list_docs_arrays(services, which, batch, engine):
    jsvc, ports, pats = services
    b = _batches(pats, jsvc.coll.sigma)[batch]
    jd, jc = jsvc.list_docs_arrays(b, max_df=16, engine=engine, max_buf=MAX_BUF)
    td, tc = ports[which].list_docs_arrays(b, max_df=16, engine=engine, max_buf=MAX_BUF)
    _same(jd, td)
    _same(jc, tc)


def test_engines_are_all_exercised(services):
    jsvc, ports, pats = services
    plan = ports["built"].plan(pats, "auto")
    assert (plan["engine"] == ENGINE_BRUTE).any() or (plan["engine"] == ENGINE_PDL).any()
    for engine, code in (("ilcp", ENGINE_ILCP), ("pdl", ENGINE_PDL)):
        docs, cnt = ports["carried"].list_docs_arrays(pats[:17], max_df=16, engine=engine,
                                                      max_buf=MAX_BUF)
        assert (ports["carried"].plan(pats[:17], engine)["engine"] == code).all()
        assert (cnt > 0).all()


def test_list_docs_lists_and_empty_batch(services):
    jsvc, ports, pats = services
    for svc in ports.values():
        assert svc.list_docs(pats[:5], max_df=8, max_buf=MAX_BUF) == \
            jsvc.list_docs(pats[:5], max_df=8, max_buf=MAX_BUF)
        d, c = svc.list_docs_arrays([], max_df=8)
        assert d.shape == (0, 8) and d.dtype == np.int32 and c.shape == (0,)
        assert svc.list_docs([], max_df=8) == []


def test_brute_window_grows_like_the_reference(services):
    jsvc, ports, pats = services
    svc = tret.RetrievalService(**{f.name: getattr(ports["built"], f.name)
                                   for f in dataclasses.fields(tret.RetrievalService)
                                   if f.init and not f.name.startswith("_")})
    # the rebuilt service has a program cache and a tally of its own
    assert svc.compile_counts == {} and svc.compiled_programs() == {}
    assert svc.compile_counts is not ports["built"].compile_counts
    ref = JService(coll=jsvc.coll, csa=jsvc.csa, ilcp=jsvc.ilcp, pdl_list=jsvc.pdl_list,
                   pdl_topk=jsvc.pdl_topk, sada=jsvc.sada, da=jsvc.da)
    # the brute-assigned patterns with the smallest occ first, then the whole
    # workload (same shape bucket), then the small batch again: the window
    # grows to the larger occ and stays there
    plan = svc.plan(pats)
    occ = np.where(plan["engine"] == ENGINE_BRUTE, plan["occ"], np.iinfo(np.int32).max)
    small = [pats[int(i)] for i in np.argsort(occ, kind="stable")[:17]]
    seen = []
    for b in (small, pats, small):
        want = ref.list_docs_arrays(b, max_df=16, max_buf=MAX_BUF)
        got = svc.list_docs_arrays(b, max_df=16, max_buf=MAX_BUF)
        _same(want[0], got[0])
        assert ref._brute_windows == svc._brute_windows
        seen.append(list(svc._brute_windows.values()))
    assert seen[0] <= seen[1] == seen[2]
    assert all(w >= tret.BRUTE_WINDOW_FLOOR for w in svc._brute_windows.values())


def test_space_report(services):
    jsvc, ports, _ = services
    want = jsvc.space_report()
    for svc in ports.values():
        got = svc.space_report()
        assert got == {k: want[k] for k in got}


def test_bucket_helpers():
    from repro.serve import retrieval as jret

    for b in range(0, 70):
        assert jret._bucket_batch(b) == tret._bucket_batch(b)
        assert jret._bucket_len(b) == tret._bucket_len(b)
        assert jret._pow2_ceil(b) == tret._pow2_ceil(b)
    assert (jret.BRUTE_WINDOW_FLOOR, jret.MAX_PATTERN_LEN) == \
        (tret.BRUTE_WINDOW_FLOOR, tret.MAX_PATTERN_LEN)
