"""Device milliseconds a batch inside the programs' replays: every
``device.<stage>`` span of the program's captured stage events, the
window pass's plan included."""

from port_bench.metrics._tracer import ms_per_batch


def read(run):
    return ms_per_batch(run, lambda r: r.name.startswith("device."))
