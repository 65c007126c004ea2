"""Milliseconds a batch the runtime spends admitting requests (``submit``
with ``normalize_patterns``): the program's ``runtime.admit`` records.
Admission runs outside ``ServeRuntime.step``."""

from port_bench.metrics._tracer import ms_per_batch


def read(run):
    return ms_per_batch(run, lambda r: r.name == "runtime.admit")
