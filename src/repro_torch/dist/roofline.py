"""Roofline accounting on NVIDIA H100 constants (counterpart of
``repro.dist.roofline``'s ``RooflineTerms`` and ``roofline_terms``).

``roofline_terms`` combines a cell's analytic FLOP and byte models (the
registry's ``meta``) with its collective traffic into three terms,
compute, memory and interconnect, each the least time the work could take
on ``chips`` cards, and names the largest.  The constants are one H100
SXM's published peaks (NVIDIA's data sheet, dense, at the 700 W limit):
989.4e12 bf16 FLOP/s on the tensor cores, 3.35e12 B/s of HBM3, and
450e9 B/s a direction of NVLink 4 for the collective term.

The reference sizes its collectives by parsing XLA's HLO text
(``parse_collectives``); the port has no HLO.  A one-card cell moves no
collective bytes; counting them over several cards waits with ROADMAP
A12.2b.
"""

from __future__ import annotations

import dataclasses

#: one H100 SXM: dense bf16 tensor-core FLOP/s
H100_PEAK_BF16_FLOPS = 989.4e12
#: one H100 SXM: HBM3 bytes/s
H100_PEAK_HBM_BPS = 3.35e12
#: NVLink 4 on an H100 SXM: bytes/s in one direction (900 GB/s both ways)
H100_NVLINK_BPS = 450e9


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    analytic_flops: float
    useful_ratio: float

    def row(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(meta: dict, chips: int, collective_bytes: float, raw_flops: float = 0.0,
                   raw_bytes: float = 0.0) -> RooflineTerms:
    """The three terms of one cell.  ``meta``: the registry's analytic
    model (``model_flops``, ``analytic_flops``, ``analytic_bytes``);
    ``collective_bytes``: bytes each card sends; ``raw_flops`` and
    ``raw_bytes``: a measured count where one exists (the larger of it and
    the analytic one is used, as the reference does with XLA's cost
    analysis).  FLOPs and bytes split evenly over ``chips``; the
    collective bytes are already per card."""
    chips = max(1, int(chips))
    model_flops = float(meta.get("model_flops", 0.0))
    flops = max(float(meta.get("analytic_flops", 0.0)), float(raw_flops))
    bytes_ = max(float(meta.get("analytic_bytes", 0.0)), float(raw_bytes))

    compute_s = flops / (chips * H100_PEAK_BF16_FLOPS)
    memory_s = bytes_ / (chips * H100_PEAK_HBM_BPS)
    collective_s = float(collective_bytes) / H100_NVLINK_BPS

    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops / flops if flops > 0 else 0.0
    return RooflineTerms(compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
                         dominant=dominant, model_flops=model_flops, analytic_flops=flops,
                         useful_ratio=useful)
