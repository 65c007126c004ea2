"""Milliseconds a batch the runtime spends on the answers once the
service has returned: the program's ``runtime.check`` (payload
validation), ``runtime.format`` (rows to Python lists) and
``runtime.answer`` (``Answer`` objects and accounting) spans."""

from port_bench.metrics._tracer import ms_per_batch

NAMES = {"runtime.check", "runtime.format", "runtime.answer"}


def read(run):
    return ms_per_batch(run, lambda r: r.name in NAMES)
