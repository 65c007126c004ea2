"""Milliseconds a batch in which a kernel or copy ran on the card, in the
profiled stretch: the device's own share of a batch, which the
profiler's cost on the host does not stretch."""


def read(run):
    prof = run.profile
    if prof is None or not prof["batches"] or prof["busy_s"] <= 0:
        return None
    return prof["busy_s"] / prof["batches"] * 1e3
