"""Resilient request-execution runtime over :class:`RetrievalService`
(counterpart of ``repro.serve.runtime``, with the same semantics).

Contract: **every admitted request gets an answer** — possibly degraded,
always flagged — **within its deadline plus at most one batch interval.**

Architecture
------------

* **Bounded admission queue** (``submit`` / ``QueueFullError``): requests
  carry absolute deadlines; batches are cut earliest-deadline-first, one
  endpoint kind per batch, sized to a power of two (the program-cache
  bucket of ``serve.retrieval``) and *shrunk* when the steady-state
  latency estimate for that (kind, bucket) would blow the earliest
  deadline's slack.
* **Retry with backoff**: a failed execution attempt (device error,
  injected fault, poisoned payload) is retried up to
  ``RuntimeConfig.max_retries`` times with exponential backoff.
* **Circuit breaker per (kind, bucket)**: attempts exhausted count as one
  breaker failure; ``breaker_threshold`` consecutive failures trip the
  bucket OPEN and the runtime stops *trying* the full path — it degrades
  immediately instead of failing slowly.
* **Graceful degradation ladder**: (1) force the cheap Brute-L engine with
  ``max_df``/``k`` clamped to the floor bucket; (2) fall back to
  ``engine="reference"``, the per-query loop on the service's device
  (deliberately not fault-instrumented, never a captured program); (3) as
  a last resort answer empty.  Every degraded answer is flagged with
  ``Answer.degraded`` and a ``cause:path`` reason string.
* **Payload validation**: executor outputs are checked against the serving
  ABI (doc ids in ``[-1, d)``, counts within ``[0, max_df]``) before they
  are formatted, so a poisoned sentinel is a retryable failure, never an
  answer.

The runtime catches every exception of an attempt, as the reference does:
a kernel that fails on the card surfaces as degraded answers, not as an
error, so clean traffic must be held to zero degradation.  Clock and sleep
are injectable; clock values and the latency EMA stay Python floats.

Tracing (:mod:`repro_torch.serve.trace`, always on): each batch is one
``runtime.batch`` span, which draws the batch id, around ``runtime.admit``
(the requests admitted since the last batch and their summed ``submit``
time), ``runtime.expire``, ``runtime.cut``, each full-path
``runtime.attempt`` (with ``runtime.retries`` as a counter), each
``runtime.degrade`` rung taken, ``runtime.check`` (payload validation),
``runtime.format`` (rows to Python lists) and ``runtime.answer``
(``Answer`` objects and accounting).  The tracer has its own clock; the
injectable ``clock`` stays what the deadlines and the EMA use.

Error taxonomy (see :mod:`repro_torch.errors`): ``InvalidQueryError`` and
``QueueFullError`` are raised from ``submit``; ``TransientExecutionError``
(incl. ``FaultInjectedError``, ``PoisonedResultError``) is consumed by the
retry and breaker machinery; a deadline that passes becomes an answer
with ``deadline_missed=True`` (degraded-empty if it passed while queued).

Circuit-breaker state machine (per (kind, bucket) key)
------------------------------------------------------

::

            success                 failure x threshold
    CLOSED ─────────▶ CLOSED      CLOSED ───────────────▶ OPEN
                                                           │ cooldown_s
       ◀── success ── HALF_OPEN ◀──────────────────────────┘
       └── failure ──▶ OPEN  (cooldown restarts)

While OPEN, the full path is skipped entirely (``short_circuits`` metric)
and answers come from the degradation ladder with cause ``breaker_open``.
After ``breaker_cooldown_s`` the next batch probes the full path
(HALF_OPEN): success closes the breaker, failure re-opens it immediately
(no threshold accumulation).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter, deque

import numpy as np

from repro_torch.data.collections import normalize_patterns
from repro_torch.errors import (
    InvalidQueryError,
    PoisonedResultError,
    QueueFullError,
)
from repro_torch.serve.retrieval import MAX_PATTERN_LEN
from repro_torch.serve.trace import tracer

KINDS = ("list", "topk", "count", "tfidf")

#: deadline-slack safety factor for batch shrinking: predicted latency must
#: fit within slack * this before we commit a batch size
_SLACK_SAFETY = 0.8
_EMA_ALPHA = 0.3


def _pow2_ceil(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    max_queue: int = 1024
    max_batch: int = 64
    default_deadline_s: float = 0.5
    #: deadline-miss tolerance unit: the contract is deadline + one batch
    #: interval, where the interval is the steady-state batch latency
    max_retries: int = 2
    backoff_base_s: float = 0.002
    backoff_factor: float = 2.0
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 1.0
    # full-path knobs
    k: int = 10
    max_df: int = 256
    max_buf: int = 1024
    tfidf_conjunctive: bool = False
    # degraded floor bucket
    floor_k: int = 4
    floor_max_df: int = 16


@dataclasses.dataclass
class Request:
    rid: int
    kind: str
    payload: object              # normalized pattern (or term list for tfidf)
    deadline: float | None       # absolute clock() time
    submitted_at: float


@dataclasses.dataclass
class Answer:
    rid: int
    kind: str
    result: object               # list | [(doc, tf)] | int | [(doc, score)]
    degraded: bool = False
    degrade_reason: str | None = None   # "cause:path", e.g. "breaker_open:floor"
    deadline_missed: bool = False
    overrun_s: float = 0.0       # how far past the deadline the answer landed
    latency_s: float = 0.0       # submit -> answer
    retries: int = 0
    path: str = "full"           # "full" | "floor" | "reference" | "empty"


@dataclasses.dataclass
class RuntimeMetrics:
    submitted: int = 0
    rejected: int = 0            # QueueFullError
    invalid: int = 0             # InvalidQueryError at admission
    answered: int = 0
    degraded: int = 0
    deadline_misses: int = 0
    max_overrun_s: float = 0.0
    retries: int = 0
    failures: int = 0            # attempts exhausted on a batch
    breaker_trips: int = 0
    short_circuits: int = 0      # batches skipped past the full path
    batches: int = 0
    degrade_reasons: Counter = dataclasses.field(default_factory=Counter)
    #: first-execution (capture-heavy) latency per (kind, bucket) — kept
    #: out of the steady-state EMA so percentiles stay honest
    compile_s: dict = dataclasses.field(default_factory=dict)
    steady_ema_s: dict = dataclasses.field(default_factory=dict)

    @property
    def degraded_fraction(self) -> float:
        return self.degraded / self.answered if self.answered else 0.0

    @property
    def deadline_miss_rate(self) -> float:
        return self.deadline_misses / self.answered if self.answered else 0.0

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["degrade_reasons"] = dict(self.degrade_reasons)
        out["compile_s"] = {f"{k}/{b}": round(v, 4)
                            for (k, b), v in self.compile_s.items()}
        out["steady_ema_s"] = {f"{k}/{b}": round(v, 4)
                               for (k, b), v in self.steady_ema_s.items()}
        out["degraded_fraction"] = round(self.degraded_fraction, 4)
        out["deadline_miss_rate"] = round(self.deadline_miss_rate, 4)
        return out


class CircuitBreaker:
    """Per-key breaker implementing the module-docstring state machine."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int, cooldown_s: float, clock=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._st: dict = {}      # key -> [state, consecutive_failures, opened_at]
        self.trips = 0

    def _entry(self, key):
        return self._st.setdefault(key, [self.CLOSED, 0, 0.0])

    def allow(self, key) -> str:
        """Effective state for the next attempt; OPEN past its cooldown
        transitions to HALF_OPEN (one probe allowed)."""
        e = self._entry(key)
        if e[0] == self.OPEN and self._clock() - e[2] >= self.cooldown_s:
            e[0] = self.HALF_OPEN
        return e[0]

    def record_success(self, key) -> None:
        self._st[key] = [self.CLOSED, 0, 0.0]

    def record_failure(self, key) -> bool:
        """Returns True when this failure trips (or re-trips) the breaker."""
        e = self._entry(key)
        e[1] += 1
        if e[0] == self.HALF_OPEN or e[1] >= self.threshold:
            e[0] = self.OPEN
            e[2] = self._clock()
            e[1] = 0
            self.trips += 1
            return True
        return False

    def state(self, key) -> str:
        return self._entry(key)[0]


class ServeRuntime:
    """Deadline-aware, fault-tolerant front of a RetrievalService.

    ``clock`` and ``sleep`` are injectable for deterministic tests (the
    breaker cooldown and retry backoff run on the same clock)."""

    def __init__(self, svc, config: RuntimeConfig | None = None, *,
                 clock=time.monotonic, sleep=time.sleep):
        self.svc = svc
        self.config = config or RuntimeConfig()
        self._clock = clock
        self._sleep = sleep
        self._queue: deque[Request] = deque()
        self._next_rid = 0
        #: requests admitted since the last batch, and their submit ns
        self._admitted, self._admit_ns = 0, 0
        self.breaker = CircuitBreaker(
            self.config.breaker_threshold, self.config.breaker_cooldown_s,
            clock=clock,
        )
        self.metrics = RuntimeMetrics()

    # -- admission -----------------------------------------------------------

    def submit(self, kind: str, payload, *, deadline_s: float | None = None) -> int:
        """Admit one request; returns its id.  Raises InvalidQueryError for
        structurally bad payloads and QueueFullError at capacity — the only
        two exceptions this runtime surfaces."""
        t0 = tracer.clock()
        if kind not in KINDS:
            self.metrics.invalid += 1
            raise InvalidQueryError(f"unknown endpoint kind {kind!r}")
        if len(self._queue) >= self.config.max_queue:
            self.metrics.rejected += 1
            raise QueueFullError(
                f"admission queue at capacity ({self.config.max_queue})"
            )
        sigma = self.svc.coll.sigma
        try:
            if kind == "tfidf":
                if isinstance(payload, (str, bytes, np.ndarray)) or not hasattr(
                    payload, "__iter__"
                ):
                    raise InvalidQueryError(
                        "tfidf payload must be a list of term patterns"
                    )
                norm = normalize_patterns(
                    list(payload), sigma=sigma, max_len=MAX_PATTERN_LEN
                )
            else:
                norm = normalize_patterns(
                    [payload], sigma=sigma, max_len=MAX_PATTERN_LEN
                )[0]
        except InvalidQueryError:
            self.metrics.invalid += 1
            raise
        now = self._clock()
        ddl = self.config.default_deadline_s if deadline_s is None else deadline_s
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(
            rid=rid, kind=kind, payload=norm,
            deadline=(now + ddl) if ddl is not None else None,
            submitted_at=now,
        ))
        self.metrics.submitted += 1
        self._admitted += 1
        self._admit_ns += tracer.clock() - t0
        return rid

    # -- batch cutting -------------------------------------------------------

    def _cut_batch(self, now: float) -> list[Request]:
        """Earliest-deadline-first, one kind per batch, power-of-two sized,
        shrunk while the steady-state estimate would blow the head's
        slack."""
        if not self._queue:
            return []
        order = sorted(
            self._queue,
            key=lambda r: (r.deadline if r.deadline is not None else math.inf, r.rid),
        )
        head = order[0]
        batch = [r for r in order if r.kind == head.kind][: self.config.max_batch]
        # Python float, not np.inf: a numpy float64 scalar here would leak
        # into every latency comparison below (the clock path stays pure
        # Python floats)
        slack = float(head.deadline - now) if head.deadline is not None else math.inf
        while len(batch) > 1:
            est = self.metrics.steady_ema_s.get((head.kind, _pow2_ceil(len(batch))))
            if est is None or est <= max(slack, 0.0) * _SLACK_SAFETY:
                break
            batch = batch[: max(1, len(batch) // 2)]
        chosen = {r.rid for r in batch}
        self._queue = deque(r for r in self._queue if r.rid not in chosen)
        return batch

    # -- endpoint plumbing ---------------------------------------------------

    def _call(self, kind: str, reqs: list[Request], path: str):
        cfg = self.config
        pats = [r.payload for r in reqs]
        svc = self.svc
        if path == "reference":
            # per-query loop: slow, program-free, not fault-instrumented
            if kind == "list":
                return svc.list_docs(pats, max_df=cfg.max_df, engine="reference",
                                     max_buf=cfg.max_buf)
            if kind == "topk":
                return svc.topk(pats, k=cfg.k, engine="reference",
                                max_buf=cfg.max_buf)
            if kind == "count":
                return [int(x) for x in svc.count(pats, engine="reference")]
            return svc.tfidf(pats, k=cfg.k, conjunctive=cfg.tfidf_conjunctive,
                             max_buf=cfg.max_buf, engine="reference")

        floor = path == "floor"
        if kind == "list":
            max_df = cfg.floor_max_df if floor else cfg.max_df
            docs, cnt = svc.list_docs_arrays(
                pats, max_df=max_df, engine="brute" if floor else "auto",
                max_buf=cfg.max_buf,
            )
            with tracer.span("runtime.check"):
                self._check_docs(docs, cnt, max_df)
            with tracer.span("runtime.format"):
                return [docs[i, : cnt[i]].tolist() for i in range(len(reqs))]
        if kind == "topk":
            k = cfg.floor_k if floor else cfg.k
            docs, tfs = svc.topk_arrays(
                pats, k=k, engine="brute" if floor else "auto",
                max_buf=cfg.max_buf,
            )
            with tracer.span("runtime.check"):
                self._check_docs(docs, None, k)
            with tracer.span("runtime.format"):
                return [
                    [(int(d), int(t)) for d, t in zip(docs[i], tfs[i]) if d >= 0]
                    for i in range(len(reqs))
                ]
        if kind == "count":
            df = np.asarray(svc.count(pats))
            with tracer.span("runtime.check"):
                if df.size and (df.min() < 0 or df.max() > svc.coll.d):
                    raise PoisonedResultError("df outside [0, d]")
            with tracer.span("runtime.format"):
                return [int(x) for x in df]
        k = cfg.floor_k if floor else cfg.k
        docs, scores = svc.tfidf_arrays(
            pats, k=k, conjunctive=cfg.tfidf_conjunctive, max_buf=cfg.max_buf
        )
        with tracer.span("runtime.check"):
            self._check_docs(docs, None, k)
        with tracer.span("runtime.format"):
            return [
                [(int(d), float(s)) for d, s in zip(docs[i], scores[i]) if d >= 0]
                for i in range(len(reqs))
            ]

    def _check_docs(self, docs, cnt, max_df) -> None:
        """Serving-ABI payload validation: a poisoned sentinel or an
        out-of-range id is an execution failure, never an answer."""
        docs = np.asarray(docs)
        if docs.size and (docs.min() < -1 or docs.max() >= self.svc.coll.d):
            raise PoisonedResultError("doc id outside [-1, d)")
        if cnt is not None:
            cnt = np.asarray(cnt)
            if cnt.size and (cnt.min() < 0 or cnt.max() > max_df):
                raise PoisonedResultError("listing count outside [0, max_df]")

    # -- execution core ------------------------------------------------------

    def _execute_batch(self, reqs: list[Request]) -> list[Answer]:
        cfg, m = self.config, self.metrics
        kind = reqs[0].kind
        key = (kind, _pow2_ceil(len(reqs)))
        m.batches += 1
        start = self._clock()
        results, path, reason, retries = None, "full", None, 0

        state = self.breaker.allow(key)
        if state == CircuitBreaker.OPEN:
            m.short_circuits += 1
            cause = "breaker_open"
        else:
            backoff = cfg.backoff_base_s
            for attempt in range(cfg.max_retries + 1):
                try:
                    with tracer.span("runtime.attempt"):
                        results = self._call(kind, reqs, "full")
                    self.breaker.record_success(key)
                    break
                except Exception:
                    retries += 1
                    m.retries += 1
                    if attempt < cfg.max_retries:
                        self._sleep(backoff)
                        backoff *= cfg.backoff_factor
            else:
                m.failures += 1
                if self.breaker.record_failure(key):
                    m.breaker_trips += 1
            if retries:
                tracer.count("runtime.retries", retries)
            cause = "retries_exhausted"

        if results is None:
            for path in ("floor", "reference"):
                try:
                    with tracer.span("runtime.degrade"):
                        results = self._call(kind, reqs, path)
                    reason = f"{cause}:{path}"
                    break
                except Exception:
                    continue
            else:
                path = "empty"
                reason = f"{cause}:empty"
                results = [0 if kind == "count" else [] for _ in reqs]

        end = self._clock()
        # injected clocks may hand back numpy scalars; the EMA and every
        # overrun/latency figure below must stay Python floats or the
        # widened dtype propagates into reported metrics arrays
        elapsed = float(end - start)
        if key not in m.compile_s and path == "full":
            m.compile_s[key] = elapsed     # first run pays the capture
        elif path == "full":
            prev = m.steady_ema_s.get(key)
            m.steady_ema_s[key] = (
                elapsed if prev is None
                else float((1 - _EMA_ALPHA) * prev + _EMA_ALPHA * elapsed)
            )

        with tracer.span("runtime.answer"):
            answers = []
            for r, res in zip(reqs, results):
                overrun = (
                    max(0.0, float(end - r.deadline))
                    if r.deadline is not None else 0.0
                )
                ans = Answer(
                    rid=r.rid, kind=kind, result=res,
                    degraded=path != "full", degrade_reason=reason,
                    deadline_missed=overrun > 0, overrun_s=overrun,
                    latency_s=float(end - r.submitted_at), retries=retries,
                    path=path,
                )
                self._account(ans)
                answers.append(ans)
        return answers

    def _account(self, ans: Answer) -> None:
        m = self.metrics
        m.answered += 1
        if ans.degraded:
            m.degraded += 1
            m.degrade_reasons[ans.degrade_reason] += 1
        if ans.deadline_missed:
            m.deadline_misses += 1
            m.max_overrun_s = max(m.max_overrun_s, ans.overrun_s)

    def _expire(self, now: float) -> list[Answer]:
        """Requests whose deadline passed while queued answer empty-degraded
        immediately — the overrun is bounded by one batch interval because
        this runs between batches."""
        dead = [r for r in self._queue
                if r.deadline is not None and r.deadline <= now]
        if not dead:
            return []
        gone = {r.rid for r in dead}
        self._queue = deque(r for r in self._queue if r.rid not in gone)
        answers = []
        for r in dead:
            ans = Answer(
                rid=r.rid, kind=r.kind,
                result=0 if r.kind == "count" else [],
                degraded=True, degrade_reason="deadline:empty",
                deadline_missed=True, overrun_s=float(now - r.deadline),
                latency_s=float(now - r.submitted_at), path="empty",
            )
            self._account(ans)
            answers.append(ans)
        return answers

    # -- driving -------------------------------------------------------------

    def step(self) -> list[Answer]:
        """Expire overdue queued requests, then cut and execute one batch
        (one ``runtime.batch`` span; nothing with an empty queue)."""
        if not self._queue:
            return []
        with tracer.batch_span("runtime.batch"):
            if self._admitted:
                tracer.add("runtime.admit", self._admit_ns, self._admitted)
                self._admitted, self._admit_ns = 0, 0
            with tracer.span("runtime.expire"):
                answers = self._expire(self._clock())
            with tracer.span("runtime.cut"):
                batch = self._cut_batch(self._clock())
            if batch:
                answers.extend(self._execute_batch(batch))
        return answers

    def run_until_idle(self) -> dict[int, Answer]:
        out: dict[int, Answer] = {}
        while self._queue:
            for ans in self.step():
                out[ans.rid] = ans
        return out

    def serve(self, requests, *, deadline_s: float | None = None) -> list[Answer]:
        """Convenience: submit ``(kind, payload)`` pairs, drain the queue,
        return answers in submission order."""
        rids = [self.submit(kind, payload, deadline_s=deadline_s)
                for kind, payload in requests]
        answers = self.run_until_idle()
        return [answers[rid] for rid in rids]

    def warmup(self, kinds=KINDS, batch_sizes=(1,)) -> dict:
        """Build (on the card: capture) the (kind, bucket) programs outside
        any deadline.

        Returns per-bucket first-batch seconds (also in ``metrics.compile_s``);
        serving traffic on a warm bucket then only sees steady-state
        latency."""
        probe = np.asarray([1], np.int32)
        for kind in kinds:
            for b in batch_sizes:
                payload = [probe] if kind == "tfidf" else probe
                for _ in range(b):
                    self.submit(kind, payload, deadline_s=1e9)
                self.run_until_idle()
        return dict(self.metrics.compile_s)
