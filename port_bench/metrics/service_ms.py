"""Milliseconds a batch in the service's endpoint calls (padding, the
plan pass, the graph replays, the copies back to the host)."""


def read(run):
    steps = sum(1 for name, _, _ in run.spans if name == "runtime.step")
    inner = sum(e - s for name, s, e in run.spans if name.startswith("service."))
    return inner / steps * 1e3 if steps else None
