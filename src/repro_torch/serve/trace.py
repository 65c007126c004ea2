"""The serving path's tracer: host spans, device spans and counters in one
process-wide instance, ``tracer``, always on.

Like ``logging``'s root logger, ``tracer`` is shared by every object of
the process, so a service built before its runtime records into it too.
The serving loop is one thread; the tracer takes no lock.

* **Host spans** (``with tracer.span("runtime.cut"): ...``): name, start
  and duration on ``time.perf_counter_ns``, the enclosing span
  (``parent``) and the batch id.  The batch id is the ordinal of the
  runtime's batch in the process, set by the ``runtime.batch`` span
  (``tracer.batch_span``); a span outside a batch carries ``None``.
* **Device spans** (``tracer.device("device.brute", ms)``): a stage's
  device milliseconds, read from the events of a captured program.
* **Counters** (``tracer.count("service.rows.brute", 57)``): a value.

Per name the tracer keeps running totals (``totals``: records, summed
ns, summed self ns, summed value; self time is a span's duration less
what its child spans cover) and a ring of the newest raw records
(``ring``, ``RING`` of them: more than 4,000 batches of the served
path), so memory stays bounded in a server that runs for days.

**Program stages.**  A program's stage boundaries are marks
(``stage("brute")`` ends the stage ``brute``) made while a ``StageClock``
is active.  ``retrieval.Program`` activates one around its function: on
CUDA tensors only while the graph is captured, so each mark is an
``external`` timing event that the graph records as a node on every
replay (no kernel, no synchronisation), read after the service's own
readback has waited for the replay; on CPU tensors around every eager
call, each mark a host clock read.  Outside a ``StageClock`` a mark does
nothing.

**The trace clock.**  ``torch.profiler`` stamps its events with
``time.time_ns``; ``Tracer.trace_ns`` maps a ``perf_counter_ns`` time onto
it, with the offset of the tightest of a few paired reads taken when the
tracer is made.
"""

from __future__ import annotations

import collections
import time

import torch

#: raw records the ring keeps (about 28 a batch of ``list_docs``)
RING = 1 << 17

HOST, DEVICE, COUNTER = "host", "device", "counter"


class Record:
    """One host span, device span or counter.  ``start`` is the tracer's
    clock when the span opened or the record was made; ``ns`` the span's
    duration (a device span's device time, ``runtime.admit``'s summed
    admission time); ``value`` what the record counts (1 for a span)."""

    __slots__ = ("_tracer", "kind", "name", "batch", "parent", "start", "ns", "value", "_inner")

    def __init__(self, tracer, kind, name, value=1, ns=0):
        self._tracer = tracer
        self.kind = kind
        self.name = name
        self.value = value
        self.ns = ns
        self._inner = 0

    @property
    def end(self) -> int:
        return self.start + self.ns

    def __enter__(self):
        t = self._tracer
        self.batch, self.parent = t.batch, t.open
        t.open = self
        self.start = t.clock()
        return self

    def __exit__(self, *exc):
        t = self._tracer
        self.ns = t.clock() - self.start
        t.open = self.parent
        if self.parent is not None:
            self.parent._inner += self.ns
        t._keep(self, self.ns - self._inner)
        return False

    def __repr__(self):
        parent = self.parent.name if self.parent is not None else None
        return (f"Record({self.kind} {self.name} batch={self.batch} parent={parent} "
                f"ns={self.ns} value={self.value})")


class _BatchSpan(Record):
    """The span of one runtime batch: it draws the batch id its children
    carry."""

    __slots__ = ()

    def __enter__(self):
        t = self._tracer
        t.batches += 1
        t.batch = t.batches
        return Record.__enter__(self)

    def __exit__(self, *exc):
        Record.__exit__(self, *exc)
        self._tracer.batch = None
        return False


class Tracer:
    """Spans, device spans and counters with running totals and a ring of
    raw records.  ``clock`` (ns) times the spans; ``wall`` (ns) is the
    profiler's clock, sampled once for ``trace_ns``."""

    def __init__(self, ring: int = RING, clock=time.perf_counter_ns, wall=time.time_ns):
        self.clock = clock
        self.ring: collections.deque = collections.deque(maxlen=ring)
        #: name -> [records, ns, self ns, value]
        self.totals: dict[str, list] = {}
        #: name -> HOST, DEVICE or COUNTER
        self.kinds: dict[str, str] = {}
        self.open: Record | None = None
        self.batch: int | None = None
        self.batches = 0
        self.stage_clock: StageClock | None = None
        pairs = []
        for _ in range(5):
            a = clock()
            w = wall()
            pairs.append((clock() - a, w - a))
        # the read between the two clock reads closest together; the wall
        # read sits at their midpoint within half their gap
        gap, offset = min(pairs)
        self.offset_ns = offset - gap // 2

    # -- recording -------------------------------------------------------------

    def span(self, name: str) -> Record:
        """A host span, entered with ``with``."""
        return Record(self, HOST, name)

    def batch_span(self, name: str) -> Record:
        """The span of one batch: it draws the next batch id, which every
        record inside it carries."""
        return _BatchSpan(self, HOST, name)

    def device(self, name: str, ms: float) -> None:
        """A device span of ``ms`` device milliseconds."""
        ns = round(ms * 1e6)
        self._stamp(Record(self, DEVICE, name, ns=ns), ns)

    def count(self, name: str, value) -> None:
        """A counter's value."""
        self._stamp(Record(self, COUNTER, name, value=value), 0)

    def add(self, name: str, ns: int, value: int) -> None:
        """A host record of ``value`` calls timed elsewhere, ``ns`` in all
        (``runtime.admit``).  It covers no part of the span open now."""
        self._stamp(Record(self, HOST, name, value=value, ns=ns), ns)

    def _stamp(self, rec: Record, self_ns: int) -> None:
        rec.batch, rec.parent, rec.start = self.batch, self.open, self.clock()
        self._keep(rec, self_ns)

    def _keep(self, rec: Record, self_ns: int) -> None:
        tot = self.totals.get(rec.name)
        if tot is None:
            tot = self.totals[rec.name] = [0, 0, 0, 0]
            self.kinds[rec.name] = rec.kind
        tot[0] += 1
        tot[1] += rec.ns
        tot[2] += self_ns
        tot[3] += rec.value
        self.ring.append(rec)

    def mark(self, name: str) -> None:
        """End the active program stage ``name`` (nothing outside a
        ``StageClock``)."""
        if self.stage_clock is not None:
            self.stage_clock.mark(name)

    def device_stages(self, clock: StageClock) -> None:
        """Record the stage times of a program's last call as device spans
        ``device.<stage>``.  On the card, call it once the program's
        outputs have been read back: the events are then complete."""
        for name, ms in clock.elapsed_ms():
            self.device(f"device.{name}", ms)

    # -- reading -----------------------------------------------------------------

    def trace_ns(self, t: int) -> int:
        """A time of ``clock`` on the profiler's clock (``time.time_ns``)."""
        return t + self.offset_ns

    def reset(self) -> None:
        """Forget the totals and the ring (the batch ordinal goes on)."""
        self.ring.clear()
        self.totals.clear()
        self.kinds.clear()

    def table(self) -> list[str]:
        """The per-name totals as text lines: records, milliseconds and self
        milliseconds a batch for spans, the value a batch for counters,
        per ``runtime.batch`` span counted."""
        batches = self.totals.get("runtime.batch", [0])[0] or 1
        lines = [f"{'span or counter':28s} {'count':>8s} {'ms/batch':>10s} "
                 f"{'self ms/batch':>14s}  ({batches} batches)"]
        for name, (n, ns, self_ns, value) in sorted(self.totals.items()):
            if self.kinds[name] == COUNTER:
                lines.append(f"{name:28s} {n:8d} {'':>10s} {'':>14s}  value/batch "
                             f"{value / batches:.3f}")
            else:
                lines.append(f"{name:28s} {n:8d} {ns / batches / 1e6:10.4f} "
                             f"{self_ns / batches / 1e6:14.4f}")
        return lines


class StageClock:
    """The stage boundaries of one program, marked while it is active (a
    ``with`` block, one at a time): ``events`` marks with CUDA timing
    events recorded on the current stream (inside a graph capture: event
    nodes the graph records on every replay), else with the tracer's
    clock.  ``elapsed_ms()`` gives (stage, ms) from each mark to the
    next."""

    __slots__ = ("tracer", "events", "names", "marks", "_prev")

    def __init__(self, tracer: Tracer, events: bool = False):
        self.tracer = tracer
        self.events = events
        self.names: list = []
        self.marks: list = []

    def __enter__(self):
        self.names.clear()
        self.marks.clear()
        self._prev = self.tracer.stage_clock
        self.tracer.stage_clock = self
        self.mark(None)
        return self

    def __exit__(self, *exc):
        self.tracer.stage_clock = self._prev
        return False

    def mark(self, name) -> None:
        if self.events:
            at = torch.cuda.Event(enable_timing=True, external=True)
            at.record()
        else:
            at = self.tracer.clock()
        self.names.append(name)
        self.marks.append(at)

    def elapsed_ms(self) -> list[tuple[str, float]]:
        m = self.marks
        if self.events:
            return [(n, a.elapsed_time(b)) for n, a, b in zip(self.names[1:], m, m[1:])]
        return [(n, (b - a) / 1e6) for n, a, b in zip(self.names[1:], m, m[1:])]


#: the process's tracer
tracer = Tracer()


def stage(name: str) -> None:
    """End the running program's stage ``name`` (a no-op unless a
    ``StageClock`` of ``tracer`` is active)."""
    tracer.mark(name)
