"""Error taxonomy of the port (the subset the query path raises).

* ``InvalidQueryError`` — the request is structurally broken (not a
  pattern at all), raised by ``normalize_patterns`` at admission time.
  Soft-invalid input (empty, over-long or out-of-alphabet patterns) is not
  an error: it normalizes to an empty query with empty results.
"""

from __future__ import annotations


class ReproError(Exception):
    """Base class for all typed errors raised by this package."""


class InvalidQueryError(ReproError, ValueError):
    """Request is structurally malformed (non-pattern payload, bad dtype,
    bad nesting) — rejected at admission, before any device work."""
