"""Deterministic fault injection for the serving stack (counterpart of
``repro.serve.faults``; numpy only).

Every degradation path of ``repro_torch.serve.runtime`` must be testable
on demand: this module installs context-manager hooks at the instrumented
sites of ``RetrievalService`` so that planner, executor and compile calls
raise, hang, or return poisoned sentinels on a seeded schedule.  The sites
sit where the reference's do, in the same order, outside every captured
program (a CUDA graph would freeze a hook), so a port and a reference fed
the same calls fire at the same ordinals.

Instrumented sites (prefix-matched, ``:``-separated segments):

    plan                 the planner program (ranges + df + engine)
    executor:list        the listing program
    executor:topk        the top-k program
    executor:tfidf       the ranked multi-term program
    compile:<kind>       building (on the card: capturing) the program of
                         a new shape bucket

The ``engine="reference"`` per-query loop is deliberately NOT instrumented
— it is the runtime's last-resort degradation target and must stay
fault-free.

Fault kinds:

    error    raise :class:`repro_torch.errors.FaultInjectedError` (a
             ``TransientExecutionError``) before the site runs
    hang     sleep ``hang_s`` seconds before the site runs (a simulated
             slow device/compile; the caller's deadline accounting sees
             the real elapsed time)
    poison   let the site run, then overwrite its output arrays with the
             ``POISON`` sentinel — exercises the runtime's payload
             validation (a poisoned answer must never reach a caller)

Schedules are deterministic: each ``FaultSpec`` draws from its own
``random.Random(seed)`` stream, one draw per matching call, so a workload
replayed against the same specs fires the same faults at the same calls.

Usage::

    with faults.inject(FaultSpec("executor", "error", rate=0.1)) as inj:
        runtime.serve(requests)
    assert inj.fired            # [(site, kind, call_ordinal), ...]
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time

import numpy as np

from repro_torch.errors import FaultInjectedError

#: sentinel written over poisoned output arrays — outside every legal value
#: range of the serving ABI (doc ids are >= -1), so payload validation in
#: the runtime must reject it
POISON = np.int32(-0xBAD)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault schedule: fire ``kind`` at sites matching ``site`` with
    probability ``rate`` per call (seeded, deterministic), at most
    ``limit`` times (None = unlimited)."""

    site: str
    kind: str                    # "error" | "hang" | "poison"
    rate: float = 0.1
    hang_s: float = 0.05
    seed: int = 0
    limit: int | None = None

    def __post_init__(self):
        if self.kind not in ("error", "hang", "poison"):
            raise ValueError(f"unknown fault kind: {self.kind!r}")

    def matches(self, site: str) -> bool:
        return site == self.site or site.startswith(self.site + ":")


#: named shortcuts accepted by ``--inject`` flags (benchmarks, launcher):
#: ``name[:rate]`` comma-separated, e.g. ``executor_fail:0.2,slow_pdl``
NAMED_FAULTS = {
    "executor_fail": ("executor", "error"),
    "executor_poison": ("executor", "poison"),
    "slow_pdl": ("executor:topk", "hang"),   # PDL-backed top-k is the slow path
    "slow_list": ("executor:list", "hang"),
    "planner_fail": ("plan", "error"),
    "compile_error": ("compile", "error"),
}


def parse_fault_specs(arg: str, rate: float = 0.1, hang_s: float = 0.05,
                      seed: int = 0):
    """Parse an ``--inject`` flag value into FaultSpecs.

    ``arg`` is a comma-separated list of names from :data:`NAMED_FAULTS`,
    each with an optional ``:rate`` suffix.  Each spec gets its own seed
    offset so schedules stay independent."""
    specs = []
    for i, tok in enumerate(t for t in arg.split(",") if t.strip()):
        name, _, rate_s = tok.strip().partition(":")
        if name not in NAMED_FAULTS:
            raise ValueError(
                f"unknown fault {name!r}; known: {sorted(NAMED_FAULTS)}"
            )
        site, kind = NAMED_FAULTS[name]
        specs.append(
            FaultSpec(site=site, kind=kind, rate=float(rate_s or rate),
                      hang_s=hang_s, seed=seed + i)
        )
    return specs


class FaultInjector:
    """Holds the active schedules and the firing log."""

    def __init__(self, *specs: FaultSpec, sleep=time.sleep):
        self.specs = specs
        self._sleep = sleep
        self._rngs = [random.Random(s.seed) for s in specs]
        self._fire_counts = [0] * len(specs)
        self.calls = 0               # instrumented calls observed
        self.fired: list = []        # (site, kind, call ordinal)

    def _due(self, idx: int, spec: FaultSpec, site: str) -> bool:
        if not spec.matches(site):
            return False
        if spec.limit is not None and self._fire_counts[idx] >= spec.limit:
            return False
        # one draw per *matching* call keeps the schedule independent of
        # what other sites do between matches
        if self._rngs[idx].random() >= spec.rate:
            return False
        self._fire_counts[idx] += 1
        self.fired.append((site, spec.kind, self.calls))
        return True

    def fire(self, site: str) -> None:
        """Called before an instrumented site runs; may raise or hang."""
        self.calls += 1
        for idx, spec in enumerate(self.specs):
            if spec.kind == "poison" or not self._due(idx, spec, site):
                continue
            if spec.kind == "hang":
                self._sleep(spec.hang_s)
            else:
                raise FaultInjectedError(site, len(self.fired))

    def poison(self, site: str, arrays: tuple) -> tuple:
        """Called on an instrumented site's output; may replace arrays with
        the POISON sentinel (integer arrays only — shapes preserved)."""
        for idx, spec in enumerate(self.specs):
            if spec.kind != "poison" or not self._due(idx, spec, site):
                continue
            return tuple(
                np.full_like(np.asarray(a), POISON)
                if np.issubdtype(np.asarray(a).dtype, np.integer)
                else np.asarray(a)
                for a in arrays
            )
        return arrays


#: the active injector; None = all hooks are no-ops (the production path
#: pays one attribute load + is-None test per instrumented call)
_ACTIVE: FaultInjector | None = None


@contextlib.contextmanager
def inject(*specs: FaultSpec, sleep=time.sleep):
    """Install fault schedules for the duration of the block (not
    reentrant — nested injectors replace, then restore, the outer one)."""
    global _ACTIVE
    prev = _ACTIVE
    inj = FaultInjector(*specs, sleep=sleep)
    _ACTIVE = inj
    try:
        yield inj
    finally:
        _ACTIVE = prev


def active() -> FaultInjector | None:
    return _ACTIVE


def fire(site: str) -> None:
    """Site hook: raise/hang per the active schedules (no-op when none)."""
    if _ACTIVE is not None:
        _ACTIVE.fire(site)


def poison(site: str, arrays: tuple) -> tuple:
    """Output hook: maybe overwrite ``arrays`` with POISON sentinels."""
    if _ACTIVE is not None:
        return _ACTIVE.poison(site, arrays)
    return arrays
