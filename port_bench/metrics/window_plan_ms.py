"""Milliseconds a batch of the Brute-L window's plan pass, whole: the
program's ``service.window`` spans (its own padding, the ``plan``
program's replay and its readbacks)."""

from port_bench.metrics._tracer import ms_per_batch


def read(run):
    return ms_per_batch(run, lambda r: r.name == "service.window")
