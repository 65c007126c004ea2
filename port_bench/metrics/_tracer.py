"""The program's own trace (``repro_torch.serve.trace``) as the per-layer
readers see it: the records whose start falls inside the measured window,
bounded by the first start and the last end of the harness's
``runtime.step`` spans (the same monotonic clock: seconds there, ns in
the program), and the ``runtime.batch`` spans among them.  A program
without a tracer, or a window without a batch, gives nothing."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
    records: list   # the tracer's records that start inside the window
    batches: int    # the runtime.batch spans among them
    ns: int         # the window's wall time


def window(run) -> Window | None:
    try:
        from repro_torch.serve.trace import tracer
    except ImportError:
        return None
    steps = [(s, e) for name, s, e in run.spans if name == "runtime.step"]
    if not steps:
        return None
    lo = round(min(s for s, _ in steps) * 1e9)
    hi = round(max(e for _, e in steps) * 1e9)
    records = [r for r in tracer.ring if lo <= r.start <= hi]
    batches = sum(1 for r in records if r.name == "runtime.batch")
    return Window(records, batches, hi - lo) if batches else None


def ms_per_batch(run, keep) -> float | None:
    """Milliseconds a batch of the records ``keep`` picks (a host span's
    duration, a device span's device time)."""
    w = window(run)
    if w is None:
        return None
    return sum(r.ns for r in w.records if keep(r)) / w.batches / 1e6
