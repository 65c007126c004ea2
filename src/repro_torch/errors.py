"""Error taxonomy of the port (counterpart of ``repro.errors``).

The split the serving runtime (``repro_torch.serve.runtime``) relies on:

* ``InvalidQueryError`` — the *request* is structurally broken (not a
  pattern at all), raised by ``normalize_patterns`` at admission time.
  Soft-invalid input (empty, over-long or out-of-alphabet patterns) is not
  an error: it normalizes to an empty query with empty results.
* ``TransientExecutionError`` — the request was fine but this *attempt*
  failed (device error, injected fault, poisoned payload).  Retryable;
  repeated occurrences trip the circuit breaker and degrade the answer.
* ``DeadlineExceeded`` — the per-request deadline passed; the runtime
  turns this into a degraded answer rather than raising to the caller.
* ``IndexIntegrityError`` — an index structure violates an invariant
  (``repro_torch.serve.validate``); the index must not serve.
* ``QueueFullError`` — bounded admission queue overflow; the only
  load-shedding signal the runtime raises to callers.
"""

from __future__ import annotations


class ReproError(Exception):
    """Base class for all typed errors raised by this package."""


class InvalidQueryError(ReproError, ValueError):
    """Request is structurally malformed (non-pattern payload, bad dtype,
    bad nesting) — rejected at admission, before any device work."""


class TransientExecutionError(ReproError):
    """A single execution attempt failed; the request itself may be fine.

    The runtime retries these with backoff; attempts exhausted count as a
    circuit-breaker failure and route the request to a degraded path."""


class FaultInjectedError(TransientExecutionError):
    """Raised by ``repro_torch.serve.faults`` at an instrumented site."""

    def __init__(self, site: str, ordinal: int):
        super().__init__(f"injected fault at {site} (firing #{ordinal})")
        self.site = site
        self.ordinal = ordinal


class PoisonedResultError(TransientExecutionError):
    """An executor returned a payload violating the serving contract
    (sentinels out of range, counts out of bounds) — treated exactly like
    an execution failure so corrupted answers are never served."""


class DeadlineExceeded(ReproError, TimeoutError):
    """The request's deadline passed before a full answer was produced."""


class IndexIntegrityError(ReproError):
    """An index structure violates a structural invariant and must not
    serve."""


class QueueFullError(ReproError):
    """Bounded admission queue is full; the request was not admitted."""
