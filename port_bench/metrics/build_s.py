"""Seconds of the service's build stages (``RetrievalService.build_seconds``:
suffix, CSA, ILCP, the PDLs, Sada, validation)."""


def read(run):
    return float(sum(run.build_seconds.values())) if run.build_seconds else None
