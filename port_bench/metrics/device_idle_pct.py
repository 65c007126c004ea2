"""Percent of the window in which no program stage ran on the card:
100 x (1 - the ``device.<stage>`` spans' device time / the window's wall
time), with no profiler running."""

from port_bench.metrics._tracer import window


def read(run):
    w = window(run)
    if w is None:
        return None
    busy = sum(r.ns for r in w.records if r.name.startswith("device."))
    return 100.0 * (1.0 - busy / w.ns)
