"""Milliseconds a batch that ``ServeRuntime.step`` spends outside the
service's endpoint call: cutting, checking, formatting, accounting."""


def read(run):
    steps = [e - s for name, s, e in run.spans if name == "runtime.step"]
    inner = sum(e - s for name, s, e in run.spans if name.startswith("service."))
    return (sum(steps) - inner) / len(steps) * 1e3 if steps else None
