"""Spans around the layers the benchmark calls, and the reading of the
profiler's trace.

Spans are host ``perf_counter`` intervals kept in memory.  In a traced run
each span is also a ``torch.profiler.record_function`` annotation, so the
device's idle gaps can be put beside what the host was doing."""

from __future__ import annotations

import contextlib
import time

#: annotations the benchmark opens carry this prefix in the trace
SPAN_PREFIX = "bench:"


class Spans:
    def __init__(self, annotate: bool = False):
        self.records: list[tuple[str, float, float]] = []
        self.annotate = annotate

    @contextlib.contextmanager
    def span(self, name: str):
        if self.annotate:
            import torch

            ctx = torch.profiler.record_function(SPAN_PREFIX + name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            try:
                yield
            finally:
                self.records.append((name, t0, time.perf_counter()))


class ServiceProxy:
    """Forwards every attribute to the service; the endpoints the runtime
    calls are timed as ``service`` spans."""

    ENDPOINTS = ("list_docs_arrays", "topk_arrays", "tfidf_arrays", "count")

    def __init__(self, svc, spans: Spans):
        self._svc = svc
        self._spans = spans

    def __getattr__(self, name):
        attr = getattr(self._svc, name)
        if name not in self.ENDPOINTS:
            return attr

        def call(payloads, *args, **kwargs):
            with self._spans.span(f"service.{name}"):
                return attr(payloads, *args, **kwargs)
        return call


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(event, f"{what}_us")() * 1000)


def device_events(prof):
    """(name, start ns, end ns) of every device activity, sorted, and the
    benchmark's own annotations (name, start ns, end ns)."""
    import torch

    dev, notes = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if e.name().startswith(SPAN_PREFIX):
            # an annotation appears on the host and, as a range, on the
            # device's timeline: only the host's copy is a span
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                notes.append((e.name()[len(SPAN_PREFIX):], start, end))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.name(), start, end))
    dev.sort(key=lambda x: x[1])
    return dev, notes


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def busy_intervals(events):
    """The union of the device events' intervals, merged, in ns."""
    out = []
    for _, s, e in events:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps_by_host(busy, notes, top: int = 10):
    """Idle seconds between device activities, by the innermost benchmark
    span open at each gap's middle ("outside spans" where none is)."""
    import bisect

    notes = sorted(notes, key=lambda x: x[1])
    starts = [s for _, s, _ in notes]
    by_label: dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) // 2
        label = "outside spans"
        # spans nest, so the latest-starting one still open is the innermost
        i = bisect.bisect_right(starts, mid) - 1
        for i in range(i, max(i - 8, -1), -1):
            if notes[i][2] >= mid:
                label = notes[i][0]
                break
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e9
    ranked = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in ranked]


def top_device_ops(events, top: int = 10):
    by: dict[str, float] = {}
    for name, s, e in events:
        by[name] = by.get(name, 0.0) + (e - s) / 1e9
    return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
