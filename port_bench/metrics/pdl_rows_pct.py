"""Percent of the planned non-empty rows that the PDL or ILCP serve, from
the window pass's counters (``service.rows.<engine>``); nothing where no
window pass runs."""

from port_bench.metrics._tracer import window


def read(run):
    w = window(run)
    if w is None:
        return None
    rows = {}
    for r in w.records:
        if r.name.startswith("service.rows."):
            rows[r.name] = rows.get(r.name, 0) + r.value
    planned = sum(rows.get(f"service.rows.{e}", 0) for e in ("brute", "ilcp", "pdl"))
    if not planned:
        return None
    return 100.0 * (rows.get("service.rows.ilcp", 0) + rows.get("service.rows.pdl", 0)) / planned
