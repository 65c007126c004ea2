"""The serving path's tracer (``repro_torch.serve.trace``): span nesting
and self time, the ring's bound, the runtime's and service's spans and
counters for each endpoint kind through ``ServeRuntime`` on the CPU, a
degraded batch, the mapping onto the profiler's clock, and (on a card
only) the stage events of a captured program."""

from __future__ import annotations

import time

import pytest
import torch

from repro_torch.core.suffix import Collection
from repro_torch.data.collections import SyntheticSpec, generate, random_substring_patterns
from repro_torch.serve import faults
from repro_torch.serve.retrieval import RetrievalService
from repro_torch.serve.runtime import RuntimeConfig, ServeRuntime
from repro_torch.serve.trace import COUNTER, DEVICE, HOST, StageClock, Tracer, tracer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Ticks:
    """A clock that reads the next of its values."""

    def __init__(self, *values):
        self.values = list(values)

    def __call__(self):
        return self.values.pop(0)


def _tracer(*ticks, ring=64):
    # five paired reads sample the trace clock's offset first
    return Tracer(ring=ring, clock=Ticks(*([0] * 10), *ticks), wall=lambda: 0)


def test_spans_nest_and_keep_self_time():
    t = _tracer(0, 10, 40, 50, 60, 100)
    with t.span("outer") as outer:
        with t.span("inner") as a:
            pass
        with t.span("inner") as b:
            pass
    assert (outer.start, outer.ns, a.start, a.ns, b.start, b.ns) == (0, 100, 10, 30, 50, 10)
    assert a.parent is outer and b.parent is outer and outer.parent is None
    assert t.open is None
    # self time: the duration less what the children cover
    assert t.totals == {"inner": [2, 40, 40, 2], "outer": [1, 100, 60, 1]}
    assert [r.name for r in t.ring] == ["inner", "inner", "outer"]
    assert t.kinds == {"inner": HOST, "outer": HOST}


def test_span_closes_when_its_block_raises():
    t = _tracer(0, 5, 7, 9)
    with pytest.raises(ValueError):
        with t.span("outer"):
            with t.span("inner"):
                raise ValueError("x")
    assert t.open is None
    assert t.totals["outer"][:3] == [1, 9, 7] and t.totals["inner"][:3] == [1, 2, 2]


def test_batch_span_draws_the_batch_id_its_records_carry():
    t = _tracer(*range(0, 100, 5))
    with t.batch_span("runtime.batch") as first:
        with t.span("runtime.cut") as cut:
            pass
        t.count("c", 3)
        t.device("device.brute", 1.5)
        t.add("runtime.admit", 400, 7)
    with t.span("outside") as outside:
        pass
    with t.batch_span("runtime.batch") as second:
        pass
    assert (first.batch, second.batch, outside.batch, t.batch) == (1, 2, None, None)
    assert cut.batch == 1 and cut.parent is first
    c, d, admit = list(t.ring)[1:4]
    assert (c.kind, c.value, c.batch, c.parent) == (COUNTER, 3, 1, first)
    assert (d.kind, d.ns, d.batch) == (DEVICE, 1_500_000, 1)
    assert (admit.kind, admit.ns, admit.value, admit.parent) == (HOST, 400, 7, first)
    # a record timed elsewhere covers no part of the open span
    assert t.totals["runtime.batch"][2] == t.totals["runtime.batch"][1] - cut.ns
    assert t.totals["runtime.admit"] == [1, 400, 400, 7]


def test_ring_keeps_the_newest_records_within_its_bound():
    t = Tracer(ring=8)
    for i in range(20):
        t.count("c", i)
    assert len(t.ring) == 8 and [r.value for r in t.ring] == list(range(12, 20))
    assert t.totals["c"][0] == 20 and t.totals["c"][3] == sum(range(20))
    t.reset()
    assert not t.ring and not t.totals


def test_stage_clock_marks_only_while_active():
    t = Tracer(clock=Ticks(*([0] * 10), 100, 250, 600, 700, 800))
    t.mark("ignored")
    clock = StageClock(t)
    with clock:
        t.mark("plan")
        t.mark("brute")
    t.mark("ignored")
    assert t.stage_clock is None
    assert clock.elapsed_ms() == [("plan", 150 / 1e6), ("brute", 350 / 1e6)]
    t.device_stages(clock)
    assert [(r.name, r.ns) for r in t.ring] == [("device.plan", 150), ("device.brute", 350)]


def test_table_lists_spans_and_counters():
    t = _tracer(*range(0, 100, 10))
    with t.batch_span("runtime.batch"):
        with t.span("runtime.cut"):
            pass
        t.count("service.brute_window", 32)
    lines = t.table()
    assert "1 batches" in lines[0]
    assert any(line.startswith("runtime.cut") for line in lines)
    assert any(line.startswith("service.brute_window") and "value/batch 32.000" in line
               for line in lines)


# -- the served path on the CPU ----------------------------------------------------


@pytest.fixture(scope="module")
def served():
    coll = generate(SyntheticSpec("version", n_base=2, n_variants=6, base_len=80,
                                  mutation_rate=0.01, seed=3))
    svc = RetrievalService.build(
        Collection(text=coll.text, doc_starts=coll.doc_starts, doc_ends=coll.doc_ends,
                   d=coll.d, sigma=coll.sigma),
        block_size=16, beta=8.0, device="cpu")
    pats = random_substring_patterns(coll, 40, 4, 12, device="cpu")
    return svc, pats


RUNTIME = ("runtime.batch", "runtime.admit", "runtime.expire", "runtime.cut",
           "runtime.attempt", "runtime.check", "runtime.format", "runtime.answer")
PROGRAM = ("service.pad", "service.program", "service.replay", "service.readback")
WINDOW = ("service.window", "service.rows.empty", "service.rows.brute", "service.rows.ilcp",
          "service.rows.pdl", "service.brute_window")
KINDS = {
    "list": RUNTIME + PROGRAM + WINDOW + ("device.plan", "device.brute", "device.ilcp",
                                          "device.pdl", "device.select"),
    "topk": RUNTIME + PROGRAM + WINDOW + ("device.plan", "device.brute", "device.pdl",
                                          "device.select"),
    "tfidf": RUNTIME + PROGRAM + ("device.ranges", "device.score"),
    "count": RUNTIME + PROGRAM + ("device.plan",),
}


def _serve(svc, kind, payloads, batch=4, **cfg):
    """Serve ``payloads`` of ``kind``; the records of its batches."""
    rt = ServeRuntime(svc, RuntimeConfig(max_batch=batch, max_df=8, k=3, max_buf=16,
                                         default_deadline_s=300.0, **cfg))
    first = tracer.batches
    answers = rt.serve([(kind, p) for p in payloads])
    ids = range(first + 1, tracer.batches + 1)
    return rt, answers, ids, [r for r in tracer.ring if r.batch in ids]


def _payloads(kind, pats):
    return [[p, pats[-1 - i]] for i, p in enumerate(pats)] if kind == "tfidf" else pats


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_served_kind_records_its_spans(served, kind):
    svc, pats = served
    rt, answers, ids, recs = _serve(svc, kind, _payloads(kind, pats))
    assert all(a.path == "full" for a in answers)
    names = {r.name for r in recs}
    assert set(KINDS[kind]) <= names, sorted(set(KINDS[kind]) - names)
    if kind in ("tfidf", "count"):
        assert not {"service.window", "service.rows.brute"} & names
    # one runtime.batch a batch, and every record inside one carries its id
    # and hangs under it
    batches = {r.batch: r for r in recs if r.name == "runtime.batch"}
    assert sorted(batches) == list(ids) and len(ids) == rt.metrics.batches == 3
    for r in recs:
        top = r
        while top.parent is not None:
            assert top.parent.batch == r.batch
            top = top.parent
        assert top is batches[r.batch]
    # admission: one record a batch, counting every request submitted
    admits = [r for r in recs if r.name == "runtime.admit"]
    assert len(admits) == 1 and admits[0].value == rt.metrics.submitted == len(pats)
    assert all(r.ns >= 0 for r in recs if r.kind != COUNTER)
    # the endpoint's spans sit under the attempt; the window's own program
    # under the window
    for r in recs:
        if r.name.startswith("service.") and r.kind == HOST and r.name != "service.window":
            assert r.parent.name in ("runtime.attempt", "service.window"), r


def test_window_counters_read_the_plan(served):
    svc, pats = served
    _, _, ids, recs = _serve(svc, "list", pats, batch=16)
    rows = {r.name: r.value for r in recs if r.name.startswith("service.rows.")}
    engine = svc.plan(pats)["engine"]
    assert rows == {name: int((engine == code).sum()) for code, name in enumerate(
        ("service.rows.empty", "service.rows.brute", "service.rows.ilcp", "service.rows.pdl"))}
    assert sum(rows.values()) == len(pats) and rows["service.rows.brute"] > 0
    # the window: the floor of 32 clamped to max_buf 16
    assert [r.value for r in recs if r.name == "service.brute_window"] == [16]


def test_degraded_batch_records_the_rung(served):
    svc, pats = served
    spec = faults.FaultSpec("executor:list", "error", rate=1.0)
    with faults.inject(spec):
        rt, answers, ids, recs = _serve(svc, "list", pats[:4], max_retries=1)
    assert all(a.degraded for a in answers)
    names = [r.name for r in recs]
    assert names.count("runtime.attempt") == 2 and "runtime.degrade" in names
    assert [r.value for r in recs if r.name == "runtime.retries"] == [2]


def test_span_maps_onto_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    def busy(ns):
        end = time.perf_counter_ns() + ns
        while time.perf_counter_ns() < end:
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer_range"):
            busy(200_000)
            with tracer.span("mapped") as s:
                busy(200_000)
            busy(200_000)
    outer = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer_range"]
    assert len(outer) == 1
    start = outer[0].start_ns()
    end = start + outer[0].duration_ns()
    assert start < tracer.trace_ns(s.start) < tracer.trace_ns(s.end) < end


def test_captured_program_stage_events_read_back():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a captured program's events exist only there")
    coll = generate(SyntheticSpec("version", n_base=2, n_variants=6, base_len=80,
                                  mutation_rate=0.01, seed=3))
    svc = RetrievalService.build(
        Collection(text=coll.text, doc_starts=coll.doc_starts, doc_ends=coll.doc_ends,
                   d=coll.d, sigma=coll.sigma), block_size=16, beta=8.0, device="cuda")
    pats = random_substring_patterns(coll, 40, 4, 8)
    for _ in range(3):  # the capture, then two replays
        n = len(tracer.ring)
        svc.list_docs_arrays(pats, max_df=8, max_buf=16)
        dev = [r for r in list(tracer.ring)[n:] if r.kind == DEVICE]
        assert [r.name for r in dev] == ["device.plan", "device.plan", "device.brute",
                                         "device.ilcp", "device.pdl", "device.select"]
        assert all(r.ns > 0 for r in dev)
