"""The index's modeled bits per character in the paper's units, summed
over the service's structures (``RetrievalService.space_report``)."""


def read(run):
    parts = [v for k, v in run.space.items() if k.endswith("_bpc")]
    return float(sum(parts)) if parts else None
