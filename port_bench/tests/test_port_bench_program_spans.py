"""The per-layer metrics that read the program's own tracer, on a tiny
traced CPU run of each kind: every one is read where it has something to
read, and the readings keep the structure of the spans (an inner span
never outlasts the span that holds it).  Structure is compared, not
timings."""

from __future__ import annotations

import pytest

from port_bench.harness import bench
from port_bench.metrics import _tracer
from port_bench.tests.test_port_bench_run import _run, _small  # noqa: F401 (autouse)

PROGRAM_METRICS = {"admit_ms", "runtime_format_ms", "window_plan_ms", "readback_wait_ms",
                   "replay_device_ms", "brute_device_ms", "device_idle_pct", "pdl_rows_pct"}
#: a window pass runs for list and topk only, and so do its counters
NO_WINDOW = {"window_plan_ms", "pdl_rows_pct"}


@pytest.fixture
def runs(monkeypatch):
    """The run each reader was handed."""
    seen = []
    load = bench._load_reader

    def loader(root, name):
        reader = load(root, name)

        def read(run):
            seen.append(run)
            return reader(run)
        return read
    monkeypatch.setattr(bench, "_load_reader", loader)
    return seen


def _values(result):
    return {k: v["value"] for k, v in result["metrics"].items()}


@pytest.mark.parametrize("name", ["dna256k.list", "dna256k.topk"])
def test_traced_run_reads_every_program_metric(name, runs):
    result, numbers = _run(name, trace=True)
    assert result["correct"], numbers
    m = _values(result)
    assert PROGRAM_METRICS <= set(m), sorted(PROGRAM_METRICS - set(m))
    assert all(m[k] >= 0 for k in PROGRAM_METRICS - {"device_idle_pct"})
    assert m["brute_device_ms"] > 0 and m["window_plan_ms"] > 0 and m["admit_ms"] > 0
    assert m["brute_device_ms"] <= m["replay_device_ms"]
    assert m["device_idle_pct"] < 100
    # the tracer's batches are the harness's steps, each inside its step
    run = runs[0]
    w = _tracer.window(run)
    steps = [(s, e) for n, s, e in run.spans if n == "runtime.step"]
    lo, hi = steps[0][0], steps[-1][1]
    step_ns = sum(e - s for s, e in steps) * 1e9
    # the harness's spans around the service calls inside the window (its
    # proxy goes on timing them in the drain after the window)
    service_ns = sum(e - s for n, s, e in run.spans
                     if n.startswith("service.") and lo <= s and e <= hi) * 1e9

    def total(*names):
        return sum(r.ns for r in w.records if r.name in names)

    batches = [r for r in w.records if r.name == "runtime.batch"]
    assert len(batches) == w.batches == len(steps)
    inner = [r for r in w.records if r.parent is not None and r.parent.name == "runtime.batch"
             and r.name != "runtime.admit"]
    assert sum(r.ns for r in inner) <= total("runtime.batch") <= step_ns
    # the runtime's answer work lies in step outside the service call; the
    # window pass and the endpoint's own readback inside it
    assert total("runtime.check", "runtime.format", "runtime.answer") <= step_ns - service_ns
    main_readback = sum(r.ns for r in w.records if r.name == "service.readback"
                        and r.parent.name != "service.window")
    assert total("service.window") + main_readback <= service_ns


@pytest.mark.parametrize("name", ["dna256k.tfidf", "dna1m.count"])
def test_traced_run_without_a_window_pass(name):
    result, numbers = _run(name, trace=True)
    assert result["correct"], numbers
    m = _values(result)
    assert PROGRAM_METRICS - NO_WINDOW <= set(m)
    assert "pdl_rows_pct" not in m and m["window_plan_ms"] == 0
    assert m["brute_device_ms"] == 0 and m["replay_device_ms"] > 0


def test_a_program_without_a_tracer_gives_nothing(monkeypatch):
    """The readers on a program that records nothing (the parent of the
    tracer): no metric, no error."""
    import sys

    monkeypatch.setitem(sys.modules, "repro_torch.serve.trace", None)
    result, _ = _run("dna256k.list", trace=True)
    assert result["correct"] and not PROGRAM_METRICS & set(result["metrics"])
