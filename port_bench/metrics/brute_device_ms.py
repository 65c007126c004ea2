"""Device milliseconds a batch of Brute-L's masked rounds: the program's
``device.brute`` stage spans (ROADMAP A6.5)."""

from port_bench.metrics._tracer import ms_per_batch


def read(run):
    return ms_per_batch(run, lambda r: r.name == "device.brute")
