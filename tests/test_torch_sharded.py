"""The port's docs-sharded service against the reference.

The reference's sharded programs stop in ``with_sharding_constraint``
under the JAX this suite runs (ROADMAP, reference-side caveats), but its
sharded build, its shards (flat ``RetrievalService``s), its ``doc_bases``
and its fingerprints all run.  So the port's ``ShardedRetrievalService``
is held to three things, on the reference sharded suite's collection
(``version``, n_base 3, n_variants 7, base_len 90, seed 5; block 16,
beta 8, 4 shards):

* the JAX flat service over the whole collection, which the reference's
  own suite asks its sharded service to equal bit for bit (tf-idf scores
  within the 2 ulp of ROADMAP C4);
* the reference's merge algebra (``src/repro/serve/sharded.py``),
  replayed in numpy on the reference shards' rows, where a truncating
  ``max_df`` or ``max_buf`` makes the merged rows depend on the shards';
* the reference's partition helpers, shard texts and fingerprints.

The reference's per-query engine takes tens of seconds a call here, so
the sharded reference path's merge is held to the reference's merge code
run over the port's shards, whose per-query engine
``tests/test_torch_reference_engine.py`` holds to the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.suffix import concat_documents as jconcat
from repro.core.suffix import subcollection as jsubcollection
from repro.data.collections import SyntheticSpec, generate, random_substring_patterns
from repro.dist.sharding import doc_shard_bounds as jbounds
from repro.dist.sharding import make_docs_mesh as jmesh
from repro.errors import IndexIntegrityError as JIntegrity
from repro.serve import validate as jval
from repro.serve.retrieval import RetrievalService as JService
from repro.serve.sharded import ShardedRetrievalService as JSharded
from repro_torch.core.suffix import Collection, subcollection
from repro_torch.dist.sharding import doc_shard_bounds, make_docs_mesh
from repro_torch.errors import IndexIntegrityError as TIntegrity
from repro_torch.serve import faults as tfaults
from repro_torch.serve import validate as tval
from repro_torch.serve.retrieval import RetrievalService as TService
from repro_torch.serve.runtime import RuntimeConfig, ServeRuntime
from repro_torch.serve.sharded import ShardedRetrievalService


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_SHARDS = 4
MAX_BUF = 256  # above every pattern's occ (91 at most): no buffer truncates
ULP_TOL = 2
GENEROUS = 300.0  # a deadline a CPU test runner cannot miss
ENGINES = ("auto", "brute", "ilcp", "pdl")
BIG = np.iinfo(np.int32).max


def _port_coll(coll):
    return Collection(text=coll.text, doc_starts=coll.doc_starts, doc_ends=coll.doc_ends,
                      d=coll.d, sigma=coll.sigma)


@pytest.fixture(scope="module")
def sides():
    coll = generate(SyntheticSpec("version", n_base=3, n_variants=7, base_len=90,
                                  mutation_rate=0.01, seed=5))
    jflat = JService.build(coll, block_size=16, beta=8.0, validate=False)
    jsh = JService.build(coll, mesh=jmesh(N_SHARDS), block_size=16, beta=8.0, validate=True)
    assert isinstance(jsh, JSharded)
    tcoll = _port_coll(coll)
    tsh = TService.build(tcoll, mesh=make_docs_mesh(N_SHARDS, device="cpu"), block_size=16,
                         beta=8.0, device="cpu")
    assert isinstance(tsh, ShardedRetrievalService)
    tflat = TService.build(tcoll, block_size=16, beta=8.0, device="cpu")
    pats = random_substring_patterns(coll, 24, 3, 14)
    assert len(pats) == 14
    return {"coll": coll, "jflat": jflat, "jsh": jsh, "tsh": tsh, "tflat": tflat,
            "pats": pats, "cache": {}}


def _cached(s, key, fn):
    if key not in s["cache"]:
        s["cache"][key] = fn()
    return s["cache"][key]


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _same(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, (want.dtype, got.dtype)
    np.testing.assert_array_equal(want, got)


# ---------------------------------------------------------------------------
# Partition helpers, shard texts, fingerprints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,n_shards", [(1, 1), (8, 4), (21, 4), (10, 3), (5, 5), (2, 4),
                                        (0, 1)])
def test_doc_shard_bounds(d, n_shards):
    try:
        want = jbounds(d, n_shards)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            doc_shard_bounds(d, n_shards)
        assert str(got.value) == str(e)
        return
    assert doc_shard_bounds(d, n_shards) == want


@pytest.mark.parametrize("dlo,dhi", [(0, 21), (0, 6), (6, 11), (16, 21), (20, 21), (7, 7),
                                     (0, 0), (21, 21), (5, 22), (-1, 3), (4, 3)])
def test_subcollection(sides, dlo, dhi):
    coll = sides["coll"]
    tcoll = _port_coll(coll)
    try:
        want = jsubcollection(coll, dlo, dhi)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            subcollection(tcoll, dlo, dhi)
        assert str(got.value) == str(e)
        return
    got = subcollection(tcoll, dlo, dhi)
    for f in ("text", "doc_starts", "doc_ends"):
        _same(getattr(want, f), getattr(got, f))
    assert (got.d, got.sigma, got.n) == (want.d, want.sigma, want.n)
    assert got.sigma == coll.sigma  # the global sigma


def test_shards_bases_and_fingerprints_are_the_references(sides):
    jsh, tsh = sides["jsh"], sides["tsh"]
    _same(jsh.doc_bases, tsh.doc_bases)
    assert tsh.n_shards == jsh.n_shards == N_SHARDS
    for s in range(N_SHARDS):
        assert tsh.shard_doc_range(s) == jsh.shard_doc_range(s)
        _same(jsh.shards[s].coll.text, tsh.shards[s].coll.text)
        _same(jsh.shards[s].coll.doc_starts, tsh.shards[s].coll.doc_starts)
        assert tsh.shards[s].device.type == "cpu"
    assert tsh.fingerprints == jsh.fingerprints
    assert sorted(tsh.fingerprints) == sorted(
        f"shard{s}:{c}" for s in range(N_SHARDS) for c in tval.COMPONENTS)
    assert tval.validate_sharded_service(tsh) == tsh.fingerprints
    assert set(tsh.build_seconds) == {f"shard{s}" for s in range(N_SHARDS)} | {"validate"}
    assert tsh.space_report()["n_shards"] == N_SHARDS
    assert [r["d"] for r in tsh.space_report()["shards"]] == [
        r["d"] for r in jsh.space_report()["shards"]]


# ---------------------------------------------------------------------------
# Every endpoint against the JAX flat service on the whole collection
# ---------------------------------------------------------------------------


def test_plan_global_occ_df_and_shard_ranges(sides):
    jflat, jsh, tsh, pats = sides["jflat"], sides["jsh"], sides["tsh"], sides["pats"]
    plan = tsh.plan(pats)
    want = jflat.plan(pats)
    _same(want["occ"], plan["occ"])
    _same(want["df"], plan["df"])
    assert plan["lo"].shape == (N_SHARDS, len(pats))
    _same(plan["occ"], (plan["hi"] - plan["lo"]).sum(axis=0).astype(np.int32))
    # the shard-local ranges and engines are each reference shard's own plan
    for s, shard in enumerate(jsh.shards):
        sp = shard.plan(pats)
        _same(sp["lo"], plan["lo"][s])
        _same(sp["hi"], plan["hi"][s])
        _same(sp["engine"], plan["engine_shard"][s])


def test_count(sides):
    jflat, tsh, pats = sides["jflat"], sides["tsh"], sides["pats"]
    want = jflat.count(pats)
    _same(want, tsh.count(pats))
    _same(want, tsh.count(pats, engine="reference"))
    _same(want, tsh.count(pats, engine="reference:brute"))


@pytest.mark.parametrize("engine", ENGINES)
def test_list_docs(sides, engine):
    coll, jflat, tsh, pats = sides["coll"], sides["jflat"], sides["tsh"], sides["pats"]
    max_df = coll.d + 1  # no truncation: every engine's answer is the set
    want = _cached(sides, ("list",), lambda: jflat.list_docs_arrays(
        pats, max_df=max_df, max_buf=MAX_BUF))
    got = tsh.list_docs_arrays(pats, max_df=max_df, engine=engine, max_buf=MAX_BUF)
    _same(want[0], got[0])
    _same(want[1], got[1])
    assert tsh.list_docs(pats, max_df=max_df, engine=engine) == \
        [want[0][i, :want[1][i]].tolist() for i in range(len(pats))]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("k", [1, 3, 21])
def test_topk(sides, engine, k):
    jflat, tsh, pats = sides["jflat"], sides["tsh"], sides["pats"]
    d = sides["coll"].d
    # rows rank by (tf desc, id asc): top-k is the prefix of the full ranking
    want = _cached(sides, ("topk",), lambda: jflat.topk_arrays(pats, k=d, max_buf=MAX_BUF))
    got = tsh.topk_arrays(pats, k=k, engine=engine, max_buf=MAX_BUF)
    _same(want[0][:, :k], got[0])
    _same(want[1][:, :k], got[1])


@pytest.mark.parametrize("conjunctive", [False, True])
def test_tfidf(sides, conjunctive):
    """Within C4's 2 ulp of the JAX flat service; bit for bit the port's
    flat service (the same fold with the same global weights), and the
    sharded reference path."""
    coll, jflat, tsh, tflat, pats = (sides[x] for x in ("coll", "jflat", "tsh", "tflat", "pats"))
    queries = [pats[i:i + 2] for i in range(0, 12, 2)] + [[pats[12]], [], pats[:4]]
    k = coll.d
    wd, ws = jflat.tfidf_arrays(queries, k=k, conjunctive=conjunctive, max_buf=MAX_BUF)
    gd, gs = tsh.tfidf_arrays(queries, k=k, conjunctive=conjunctive, max_buf=MAX_BUF)
    _same(wd >= 0, gd >= 0)
    assert _ulps(ws, gs).max(initial=0) <= ULP_TOL
    full = [{int(x): s for x, s in zip(wd[q], ws[q]) if x >= 0} for q in range(len(wd))]
    for q in range(len(wd)):
        for w, g in zip(wd[q], gd[q]):
            if w != g:  # a tie within 2 ulp may order two documents either way
                assert _ulps(full[q][int(w)], full[q][int(g)]) <= ULP_TOL, (q, w, g)
    fd, fs = tflat.tfidf_arrays(queries, k=k, conjunctive=conjunctive, max_buf=MAX_BUF)
    _same(fd, gd)
    _same(fs, gs)
    got = tsh.tfidf(queries, k=k, conjunctive=conjunctive, max_buf=MAX_BUF)
    assert tsh.tfidf(queries, k=k, conjunctive=conjunctive, max_buf=MAX_BUF,
                     engine="reference") == got
    assert got == tflat.tfidf(queries, k=k, conjunctive=conjunctive, max_buf=MAX_BUF)


# ---------------------------------------------------------------------------
# Truncation: the reference's merge replayed on the reference shards' rows
# ---------------------------------------------------------------------------

PIN_WINDOW = 32


@pytest.fixture
def pinned(sides):
    """The Brute-L window pinned on both packages' shards and on the port's
    sharded service, restored afterwards."""
    svcs = [sides["tsh"], *sides["tsh"].shards, *sides["jsh"].shards]
    for svc in svcs:
        svc.brute_window = PIN_WINDOW
    yield sides
    for svc in svcs:
        svc.brute_window = None


def _merge_lists(rows, bases, W):
    """``sharded.py:174-187``: offset, concatenate, sort, cut to W."""
    docs = np.stack([np.where(d >= 0, d + b, -1) for (d, _), b in zip(rows, bases)])
    total = np.sum([c for _, c in rows], axis=0)
    S, B, _ = docs.shape
    flat = docs.swapaxes(0, 1).reshape(B, S * W)
    s = np.sort(np.where(flat < 0, BIG, flat), axis=1)[:, :W]
    return np.where(s == BIG, -1, s).astype(np.int32), np.minimum(total, W).astype(np.int32)


def _merge_topk(rows, bases, K):
    """``sharded.py:211-227``: offset, concatenate, (tf desc, id asc)."""
    docs = np.stack([np.where(d >= 0, d + b, -1) for (d, _), b in zip(rows, bases)])
    tfs = np.stack([t for _, t in rows])
    S, B, _ = docs.shape
    d2 = docs.swapaxes(0, 1).reshape(B, S * K)
    t2 = tfs.swapaxes(0, 1).reshape(B, S * K)
    ok = d2 >= 0
    dkey = np.where(ok, d2, BIG)
    order = np.lexsort((dkey, np.where(ok, -t2, BIG)), axis=-1)[:, :K]
    top = np.take_along_axis(dkey, order, axis=1)
    good = top < BIG
    return (np.where(good, top, -1).astype(np.int32),
            np.where(good, np.take_along_axis(t2, order, axis=1), 0).astype(np.int32))


def test_truncating_list_is_the_references_merge(pinned):
    """``auto`` sends the shards' queries to Brute-L and PDL, whose
    truncated rows differ."""
    tsh, jsh, pats = pinned["tsh"], pinned["jsh"], pinned["pats"]
    max_df, engine = 3, "auto"
    assert len(np.unique(tsh.plan(pats)["engine_shard"])) >= 3  # empty, brute, pdl
    rows = [sh.list_docs_arrays(pats, max_df=max_df, engine=engine, max_buf=MAX_BUF)
            for sh in jsh.shards]
    for want, tshard in zip(rows, tsh.shards):  # the per-shard rows
        got = tshard.list_docs_arrays(pats, max_df=max_df, engine=engine, max_buf=MAX_BUF)
        _same(want[0], got[0])
        _same(want[1], got[1])
    want = _merge_lists(rows, jsh.doc_bases, max_df)
    assert (want[1] == max_df).any() and (np.stack([c for _, c in rows]) > 0).sum(0).max() > 1
    got = tsh.list_docs_arrays(pats, max_df=max_df, engine=engine, max_buf=MAX_BUF)
    _same(want[0], got[0])
    _same(want[1], got[1])


def test_truncating_topk_is_the_references_merge(pinned):
    tsh, jsh, pats = pinned["tsh"], pinned["jsh"], pinned["pats"]
    k, max_buf = 3, 4  # the gather's buffer truncates: partial frequencies
    rows = [sh.topk_arrays(pats, k=k, engine="pdl", max_buf=max_buf) for sh in jsh.shards]
    for want, tshard in zip(rows, tsh.shards):
        got = tshard.topk_arrays(pats, k=k, engine="pdl", max_buf=max_buf)
        _same(want[0], got[0])
        _same(want[1], got[1])
    want = _merge_topk(rows, jsh.doc_bases, k)
    got = tsh.topk_arrays(pats, k=k, engine="pdl", max_buf=max_buf)
    _same(want[0], got[0])
    _same(want[1], got[1])


# ---------------------------------------------------------------------------
# The reference's degenerate shards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def skewed():
    """The reference suite's 8 tiny documents under a 4-way split (bounds
    (0,2)(2,4)(4,6)(6,8)): ``common`` is in every document, ``only0`` in
    document 0 alone, ``absent`` nowhere.  The oracle counts each
    pattern's occurrences in each document's symbols."""
    docs = [[1, 2, 3] + [4] * (i + 1) for i in range(8)]
    docs[0] = [1, 2, 3, 7, 7, 7]
    coll = jconcat(docs)
    tsh = ShardedRetrievalService.build(_port_coll(coll), make_docs_mesh(N_SHARDS, "cpu"),
                                        block_size=8, beta=4.0, device="cpu")
    text = np.asarray(coll.text)
    pats = {"common": text[0:3], "only0": text[3:5],
            "absent": np.asarray([text[3], text[0], text[3]])}

    def tf(p):
        out = []
        for a, b in zip(coll.doc_starts, coll.doc_ends):
            doc, m = text[a:b], len(p)
            out.append(sum(np.array_equal(doc[i:i + m], p) for i in range(len(doc) - m + 1)))
        return out

    return coll, tsh, pats, tf


def test_all_hits_in_one_shard(skewed):
    coll, tsh, p, tf = skewed
    got = tsh.list_docs([p["only0"]], max_df=coll.d + 1, max_buf=MAX_BUF)
    assert got == [[i for i, t in enumerate(tf(p["only0"])) if t]] == [[0]]
    lo, hi = tsh.shard_doc_range(0)
    assert got[0] and all(lo <= d < hi for d in got[0])


def test_empty_answer_every_shard(skewed):
    coll, tsh, p, tf = skewed
    assert not any(tf(p["absent"]))
    assert int(tsh.count([p["absent"]])[0]) == 0
    assert tsh.list_docs([p["absent"]], max_df=coll.d + 1, max_buf=MAX_BUF) == [[]]
    assert tsh.topk([p["absent"]], k=4, max_buf=MAX_BUF) == [[]]
    assert tsh.tfidf([[p["absent"]]], k=4, max_buf=MAX_BUF) == [[]]


def test_k_exceeds_any_single_shards_hits(skewed):
    coll, tsh, p, tf = skewed
    pats = [p["common"], p["only0"]]
    got = tsh.topk(pats, k=coll.d, max_buf=MAX_BUF)
    want = [sorted(((i, t) for i, t in enumerate(tf(x)) if t), key=lambda it: (-it[1], it[0]))
            for x in pats]
    assert got == want
    assert len(got[0]) == coll.d  # the union spans every shard


# ---------------------------------------------------------------------------
# The reference path: the reference's host merge over the same shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sub", ENGINES)
def test_reference_list_and_topk_merge(sides, sub):
    tsh = sides["tsh"]
    pats = sides["pats"][:3]  # the per-query PDL runs its plain gather here
    engine = "reference" if sub == "auto" else f"reference:{sub}"
    max_buf = 64
    for max_df in (3, sides["coll"].d + 1):
        want = JSharded._list_docs_reference(tsh, pats, max_df, sub, max_buf)
        assert tsh.list_docs(pats, max_df=max_df, engine=engine, max_buf=max_buf) == want
    if sub != "ilcp":
        want = JSharded._topk_reference(tsh, pats, 3, sub, max_buf)
        assert tsh.topk(pats, k=3, engine=engine, max_buf=max_buf) == want
    assert tsh.list_docs([], engine=engine) == [] and tsh.topk([], engine=engine) == []


def test_reference_count_merge(sides):
    tsh, pats = sides["tsh"], sides["pats"]
    want = JSharded.count(tsh, pats, engine="reference")
    _same(want, tsh.count(pats, engine="reference"))


# ---------------------------------------------------------------------------
# Programs, the runtime, validation
# ---------------------------------------------------------------------------


def test_one_program_per_endpoint_bucket(sides):
    coll, tsh, pats = sides["coll"], sides["tsh"], sides["pats"]
    queries = [pats[i:i + 2] for i in range(0, 8, 2)]
    tsh.list_docs(pats, max_df=coll.d + 1, max_buf=MAX_BUF)
    tsh.topk(pats, k=3, max_buf=MAX_BUF)
    tsh.tfidf(queries, k=3, max_buf=MAX_BUF)
    tsh.count(pats)
    before = dict(tsh.compile_counts)
    # the same buckets again: nothing new
    tsh.list_docs(pats, max_df=coll.d + 1, max_buf=MAX_BUF)
    tsh.topk(pats, k=3, max_buf=MAX_BUF)
    tsh.tfidf(queries, k=3, max_buf=MAX_BUF)
    tsh.count(pats, engine="bogus")
    assert tsh.compile_counts == before
    assert sum(before.values()) == len(tsh.compiled_programs())
    assert all(p.graph is None for p in tsh.compiled_programs().values())  # CPU: eager
    tsh.list_docs(pats[:2], max_df=coll.d + 1, max_buf=MAX_BUF)  # a new batch bucket
    assert tsh.compile_counts["list"] == before["list"] + 1
    assert tsh.compile_counts["plan"] == before["plan"] + 1
    assert tsh.compile_counts.keys() == {"plan", "list", "topk", "tfidf"}


def _runtime_pass(svc, requests, specs=()):
    rt = ServeRuntime(svc, RuntimeConfig(default_deadline_s=GENEROUS, backoff_base_s=0.0,
                                         max_retries=1, max_buf=MAX_BUF))
    rt.serve(requests)  # warm: every bucket and window built before the schedule
    with tfaults.inject(*specs) as inj:
        answers = rt.serve(requests)
    return ([(a.kind, a.result, a.degraded, a.degrade_reason, a.retries, a.path)
             for a in answers], inj.fired)


@pytest.mark.parametrize("faulted", [False, True])
def test_runtime_over_the_sharded_service(sides, faulted):
    """The same requests through ``ServeRuntime`` over the sharded and the
    flat port services give the same answers and the same fault log."""
    pats = sides["pats"]
    requests = ([("list", p) for p in pats[:6]] + [("count", p) for p in pats[6:9]]
                + [("topk", p) for p in pats[9:12]] + [("tfidf", pats[12:14])])
    specs = tfaults.parse_fault_specs("executor_fail", rate=0.5) if faulted else ()
    got, got_fired = _runtime_pass(sides["tsh"], requests, specs)
    want, want_fired = _runtime_pass(sides["tflat"], requests, specs)
    assert got == want and got_fired == want_fired
    if faulted:
        assert got_fired and any(a[2] for a in got)
    else:
        assert not any(a[2] for a in got)
        assert got[0][1] == sides["tsh"].list_docs([pats[0]], max_df=256, max_buf=MAX_BUF,
                                                   engine="reference")[0]


def _errors(fn_j, fn_t):
    with pytest.raises(JIntegrity) as want:
        fn_j()
    with pytest.raises(TIntegrity) as got:
        fn_t()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_validator_rejects_a_tampered_shard(sides):
    jsh, tsh, d = sides["jsh"], sides["tsh"], sides["coll"].d

    def tampered(svc, full):
        shards = list(svc.shards)
        shards[1] = dataclasses.replace(shards[1], da=full(shards[1].da))
        return dataclasses.replace(svc, shards=shards)

    msg = _errors(
        lambda: jval.validate_sharded_service(
            tampered(jsh, lambda da: np.full_like(np.asarray(da), d + 9))),
        lambda: tval.validate_sharded_service(
            tampered(tsh, lambda da: torch.full_like(da, d + 9))))
    assert msg == "da: document-array entry out of [0, d)"


@pytest.mark.parametrize("bases", [[0, 6, 11, 15], [0, 6, 11, 17], [1, 6, 11, 16],
                                   [0, 11, 6, 16], [0, 6, 11]])
def test_validator_rejects_a_bad_partition(sides, bases):
    jsh, tsh = sides["jsh"], sides["tsh"]
    assert jsh.doc_bases.tolist() == [0, 6, 11, 16]
    bases = np.asarray(bases, np.int32)
    _errors(lambda: jval.validate_sharded_service(dataclasses.replace(jsh, doc_bases=bases)),
            lambda: tval.validate_sharded_service(dataclasses.replace(tsh, doc_bases=bases)))


def test_mesh_and_device_rules(sides):
    tcoll = _port_coll(sides["coll"])
    with pytest.raises(ValueError) as want:
        jbounds(2, 4)
    with pytest.raises(ValueError) as got:
        ShardedRetrievalService.build(_port_coll(jconcat([[1, 2], [2, 1]])),
                                      make_docs_mesh(4, "cpu"), device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        make_docs_mesh(0, "cpu")
    with pytest.raises(ValueError, match="mesh"):
        ShardedRetrievalService.build(tcoll, make_docs_mesh(2, "cpu"), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_docs_mesh(N_SHARDS)
        with pytest.raises(RuntimeError, match="CUDA"):
            TService.build(tcoll, mesh=make_docs_mesh(N_SHARDS, "cpu"))
