"""Kernels the card ran a batch in the profiled window (the graph
replays' nodes and the host path's own launches; copies excluded)."""


def read(run):
    prof = run.profile
    if prof is None or not prof["batches"] or not prof["kernels"]:
        return None
    return prof["kernels"] / prof["batches"]
