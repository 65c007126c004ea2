"""The host cost of the serving tracer (``repro_torch.serve.trace``): one
span, one span inside a batch span, one counter, one device span, and one
``time.perf_counter_ns`` read, each the median of 7 repeats of 200,000
less an empty loop's cost, in ns.  Prints one JSON line.

    PYTHONPATH=src python scripts/tracer_cost.py

Run it on the host that serves: the cost is the host CPU's."""

from __future__ import annotations

import json
import statistics
import time

from repro_torch.serve.trace import Tracer

N = 200_000


def per_call_ns(fn) -> float:
    runs = []
    for _ in range(7):
        t0 = time.perf_counter_ns()
        fn()
        runs.append((time.perf_counter_ns() - t0) / N)
    return statistics.median(runs)


def main() -> None:
    t = Tracer()

    def empty():
        for _ in range(N):
            pass

    def spans():
        for _ in range(N):
            with t.span("a"):
                pass

    def nested():
        with t.batch_span("runtime.batch"):
            for _ in range(N):
                with t.span("b"):
                    pass

    def counters():
        for _ in range(N):
            t.count("c", 3)

    def devices():
        for _ in range(N):
            t.device("device.x", 1.25)

    def clock():
        for _ in range(N):
            time.perf_counter_ns()

    loop = per_call_ns(empty)
    out = {name: per_call_ns(fn) - loop for name, fn in (
        ("span_ns", spans), ("nested_span_ns", nested), ("counter_ns", counters),
        ("device_span_ns", devices), ("clock_read_ns", clock))}
    print(json.dumps(dict(out, loop_ns=loop)))


if __name__ == "__main__":
    main()
