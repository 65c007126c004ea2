"""Milliseconds a batch the host waits in the copies of the endpoint's
own program's outputs (``service.readback`` spans outside the window
pass): the replay's device time that the host has not covered."""

from port_bench.metrics._tracer import ms_per_batch


def _main(r):
    return r.name == "service.readback" and (r.parent is None
                                             or r.parent.name != "service.window")


def read(run):
    return ms_per_batch(run, _main)
