"""The port's serving runtime against the reference's.

Both runtimes serve the same requests on the same collection (the
reference runtime tests' own: ``version``, n_base 2, n_variants 6,
base_len 80, seed 3) under the same fault schedules, each through its own
package's ``faults.inject``, with a fake clock whose ``sleep`` advances it
(so backoff and injected hangs are deterministic).  Every case of
``tests/test_serve_runtime.py`` that serves traffic must give identical
``Answer``s (every field; tf-idf scores within 2 ulp), an identical
``FaultInjector.fired`` log and identical ``RuntimeMetrics.as_dict()``.
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.data.collections import SyntheticSpec, generate, random_substring_patterns
from repro.errors import InvalidQueryError as JInvalid
from repro.errors import QueueFullError as JQueueFull
from repro.serve import faults as jfaults
from repro.serve import runtime as jruntime
from repro.serve.retrieval import RetrievalService as JService
from repro_torch.core.suffix import Collection
from repro_torch.kernels import backward_search as kbs
from repro_torch.errors import FaultInjectedError
from repro_torch.errors import InvalidQueryError as TInvalid
from repro_torch.errors import QueueFullError as TQueueFull
from repro_torch.serve import faults as tfaults
from repro_torch.serve import retrieval as tret
from repro_torch.serve import runtime as truntime
from repro_torch.serve.retrieval import RetrievalService as TService


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GENEROUS = 300.0  # deadline that a CPU test runner cannot miss
ULP_TOL = 2


@pytest.fixture(scope="module")
def sides():
    coll = generate(SyntheticSpec("version", n_base=2, n_variants=6,
                                  base_len=80, mutation_rate=0.01, seed=3))
    jsvc = JService.build(coll, block_size=16, beta=8.0)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tsvc = TService.build(tcoll, block_size=16, beta=8.0, device="cpu")
    pats = random_substring_patterns(coll, 40, 4, 12)
    assert len(pats) == 12
    ref = types.SimpleNamespace(svc=jsvc, faults=jfaults, rt=jruntime,
                                invalid=JInvalid, queue_full=JQueueFull)
    port = types.SimpleNamespace(svc=tsvc, faults=tfaults, rt=truntime,
                                 invalid=TInvalid, queue_full=TQueueFull)
    return ref, port, pats


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _runtime(s, clock, **over):
    kw = dict(default_deadline_s=GENEROUS, backoff_base_s=0.0)
    kw.update(over)
    return s.rt.ServeRuntime(s.svc, s.rt.RuntimeConfig(**kw), clock=clock, sleep=clock.sleep)


def _inject(s, clock, specs):
    """``specs``: a ``parse_fault_specs`` string with its rate, or FaultSpec
    keyword dicts; built with the side's own fault module."""
    if isinstance(specs, tuple):
        built = s.faults.parse_fault_specs(specs[0], rate=specs[1])
    else:
        built = [s.faults.FaultSpec(**kw) for kw in specs]
    return s.faults.inject(*built, sleep=clock.sleep)


# ---------------------------------------------------------------------------
# Cases: each drives one side and returns (answers, fired log, runtime, extra)
# ---------------------------------------------------------------------------


def _served(specs, cfg, requests):
    def case(s, clock, pats):
        rt = _runtime(s, clock, **cfg)
        with _inject(s, clock, specs) as inj:
            answers = rt.serve(requests(pats))
        return answers, inj.fired, rt, None
    return case


def _mixed(pats):
    return [("count" if i % 3 == 0 else "list", pats[i % len(pats)]) for i in range(48)]


def _ranked(pats):
    return ([("topk", p) for p in pats[:6]]
            + [("tfidf", [pats[i], pats[(i + 3) % len(pats)]]) for i in range(6)])


def _expiry(s, clock, pats):
    rt = s.rt.ServeRuntime(s.svc, s.rt.RuntimeConfig(backoff_base_s=0.0), clock=clock,
                           sleep=clock.sleep)
    rt.submit("count", pats[0], deadline_s=0.05)
    rt.submit("count", pats[1], deadline_s=GENEROUS)
    clock.t += 0.2          # the first request's deadline passes while queued
    answers = sorted(rt.step(), key=lambda a: a.rid)
    return answers, [], rt, None


def _shrink(s, clock, pats):
    rt = s.rt.ServeRuntime(s.svc, s.rt.RuntimeConfig(max_batch=8), clock=clock,
                           sleep=clock.sleep)
    for b, est in ((8, 10.0), (4, 10.0), (2, 10.0), (1, 0.001)):
        rt.metrics.steady_ema_s[("count", b)] = est
    for p in pats[:8]:
        rt.submit("count", p, deadline_s=1.0)
    batch = rt._cut_batch(clock())
    answers = rt.run_until_idle()
    return [answers[r] for r in sorted(answers)], [], rt, [r.rid for r in batch]


def _breaker(s, clock, pats):
    rt = _runtime(s, clock, max_retries=0, breaker_threshold=2, breaker_cooldown_s=1.0)
    answers = []
    with _inject(s, clock, [dict(site="executor", kind="error", rate=1.0)]) as inj:
        for p in pats[:3]:      # failure 1, failure 2 (trips), then OPEN
            answers += rt.serve([("list", p)])
    clock.t += 2.0              # cooldown elapses: the HALF_OPEN probe runs clean
    answers += rt.serve([("list", pats[0])])
    return answers, inj.fired, rt, rt.breaker.state(("list", 1))


def _warmup(s, clock, pats):
    rt = _runtime(s, clock)
    compile_s = rt.warmup(kinds=("count", "list", "topk", "tfidf"), batch_sizes=(1, 2))
    return [], [], rt, sorted(compile_s)


def _admission(s, clock, pats):
    rt = _runtime(s, clock, max_queue=2)
    sigma = s.svc.coll.sigma
    raised = []
    for kind, payload in (("list", np.ones((2, 2))), ("frobnicate", np.ones(3, np.int32)),
                          ("tfidf", np.ones(3, np.int32))):
        with pytest.raises(s.invalid):
            rt.submit(kind, payload)
        raised.append(kind)
    rt.submit("count", pats[0])
    rt.submit("count", pats[1])
    with pytest.raises(s.queue_full):
        rt.submit("count", pats[2])
    answers = rt.step()
    # soft-invalid input is admitted and answers empty, not degraded
    soft = _runtime(s, clock)
    answers += soft.serve([("list", np.array([], dtype=np.int32)),
                           ("list", np.full(4, sigma + 5, dtype=np.int32)),
                           ("count", np.full(4, sigma + 5, dtype=np.int32))])
    return answers, [], rt, (raised, soft.metrics.as_dict())


CASES = {
    "retry_then_success": _served(
        [dict(site="executor", kind="error", rate=1.0, limit=1)], dict(max_retries=2),
        lambda p: [("list", p[0])]),
    "retries_exhausted": _served(
        [dict(site="executor", kind="error", rate=1.0)], dict(max_retries=1),
        lambda p: [("list", x) for x in p[:3]]),
    "poison": _served(
        [dict(site="executor", kind="poison", rate=1.0)], dict(max_retries=0),
        lambda p: [("topk", p[0])]),
    "planner_and_compile_faults": _served(
        ("planner_fail:1.0,compile_error:1.0", 0.1), dict(max_retries=0),
        lambda p: [("count", p[0]), ("list", p[1])]),
    "mixed_workload": _served(
        ("executor_fail,slow_list,compile_error", 0.2), {}, _mixed),
    "ranked_under_faults": _served(
        ("executor_fail,executor_poison,slow_pdl", 0.3), dict(max_batch=4), _ranked),
    "clean_every_kind": _served(
        [], dict(max_batch=4),
        lambda p: [(k, [x, p[0]] if k == "tfidf" else x)
                   for x in p[:5] for k in ("list", "topk", "count", "tfidf")]),
    "floor_every_kind": _served(
        [dict(site=site, kind="error", rate=1.0, limit=1)
         for site in ("plan", "executor:list", "executor:topk", "executor:tfidf")],
        dict(max_retries=0),
        lambda p: [("count", p[0]), ("list", p[1]), ("topk", p[2]), ("tfidf", [p[3], p[4]])]),
    "queued_expiry": _expiry,
    "batch_shrinking": _shrink,
    "breaker_trip_and_recovery": _breaker,
    "warmup": _warmup,
    "admission": _admission,
}


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _assert_same_answer(want, got):
    w, g = dataclasses.asdict(want), dataclasses.asdict(got)
    wres, gres = w.pop("result"), g.pop("result")
    assert w == g
    if want.kind != "tfidf":
        assert wres == gres, want.rid
        return
    # scores within 2 ulp; ids may swap only between 2-ulp-tied scores
    assert len(wres) == len(gres), want.rid
    for (wd, ws), (gd, gs) in zip(wres, gres):
        assert _ulps(ws, gs) <= ULP_TOL, (want.rid, ws, gs)
        if wd != gd:
            assert _ulps([s for d, s in wres if d == gd] or [np.inf], gs) <= ULP_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_runtime_matches_reference(sides, name):
    """Answers, fired log and metrics of one case, port against reference."""
    ref, port, pats = sides
    want = CASES[name](ref, FakeClock(), pats)
    got = CASES[name](port, FakeClock(), pats)
    assert len(want[0]) == len(got[0])
    for a, b in zip(want[0], got[0]):
        _assert_same_answer(a, b)
    assert want[1] == got[1]
    assert want[2].metrics.as_dict() == got[2].metrics.as_dict()
    assert want[3] == got[3]


def test_cases_reach_every_rung(sides):
    """The cases above drive the whole ladder on the port: the full path,
    a retry, the floor, the reference rung, the breaker and expiry."""
    _, port, pats = sides
    seen = {}
    for name in ("retry_then_success", "poison", "retries_exhausted",
                 "breaker_trip_and_recovery", "queued_expiry", "floor_every_kind"):
        answers, _, _, _ = CASES[name](port, FakeClock(), pats)
        for a in answers:
            seen.setdefault(a.path, set()).add(a.degrade_reason)
    assert {"full", "floor", "reference", "empty"} <= set(seen)
    assert "deadline:empty" in seen["empty"]
    assert any(r.startswith("breaker_open") for r in seen["reference"] | seen["floor"])
    assert seen["floor"] == {"retries_exhausted:floor"}


def test_poison_never_reaches_an_answer(sides):
    _, port, pats = sides
    rt = _runtime(port, FakeClock(), max_retries=0)
    with tfaults.inject(tfaults.FaultSpec("executor", "poison", rate=1.0)):
        answers = rt.serve([("topk", p) for p in pats[:4]] + [("list", p) for p in pats[:4]])
    for a in answers:
        assert a.degraded
        docs = [d for d, _ in a.result] if a.kind == "topk" else a.result
        assert all(0 <= d < port.svc.coll.d for d in docs)


def test_compile_fault_leaves_no_program(sides):
    """A compile fault fires before the program is built: no cache entry,
    no tally; the retry builds it once."""
    _, port, pats = sides
    svc = port.svc
    batch = list(pats[:3]) * 11        # a bucket of 64 no other test uses
    before_cache, before_counts = svc.compiled_programs(), dict(svc.compile_counts)
    with tfaults.inject(tfaults.FaultSpec("compile:list", "error", rate=1.0, limit=1)) as inj:
        with pytest.raises(FaultInjectedError):
            svc.list_docs_arrays(batch, max_df=32, max_buf=512)
        assert [f[:2] for f in inj.fired] == [("compile:list", "error")]
        assert set(svc.compiled_programs()) - set(before_cache) == {("plan", ((64, 8),))}
        assert svc.compile_counts.get("list", 0) == before_counts.get("list", 0)
        docs, cnt = svc.list_docs_arrays(batch, max_df=32, max_buf=512)
    assert svc.compile_counts["list"] == before_counts.get("list", 0) + 1
    assert docs.shape == (33, 32) and (cnt > 0).all()


def test_failed_capture_leaves_no_program(sides, monkeypatch):
    """A program whose CUDA-graph capture raises: the error reaches the
    caller (the runtime's retry builds again), no cache entry and no tally
    remain, and the wrappers keep only the warm-up run's launch (the
    capture's increments are undone).  The card's stream and graph calls
    are stood in for on CPU tensors; the backward search counts its plain
    runs as launches."""
    _, port, pats = sides
    svc = port.svc
    real_plain = kbs.backward_search_plain

    def counted_plain(*a, **k):
        kbs.backward_search.launches += 1
        return real_plain(*a, **k)

    class CaptureFailed(RuntimeError):
        pass

    @contextlib.contextmanager
    def failing_graph(graph):
        yield
        raise CaptureFailed("capture failed")

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(kbs, "backward_search_plain", counted_plain)
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", failing_graph)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 0)
    init = tret.Program.__init__

    def capturing_init(self, fn, args):
        init(self, fn, args)
        self._capture(args)

    monkeypatch.setattr(tret.Program, "__init__", capturing_init)
    batch = list(pats[:5]) * 25         # a bucket of 128 no other test uses
    cache, counts = svc.compiled_programs(), dict(svc.compile_counts)
    before = kbs.backward_search.launches
    with pytest.raises(CaptureFailed):
        svc.plan(batch)
    assert kbs.backward_search.launches == before + 1      # the warm-up run only
    assert svc.compiled_programs() == cache and svc.compile_counts == counts
    monkeypatch.setattr(tret.Program, "__init__", init)
    plan = svc.plan(batch)
    assert svc.compile_counts["plan"] == counts["plan"] + 1
    np.testing.assert_array_equal(plan["df"][:5], svc.count(pats[:5]))
