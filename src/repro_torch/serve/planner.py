"""Query planner — stage 1 of the batched query engine (counterpart of
``repro.serve.planner``).

One pass over a padded pattern batch computes (lo, hi) by backward search,
df by Sadakane counting, occ = hi - lo, and a per-query engine code:
Brute-L when occ/df is below the threshold, PDL otherwise (Section 6.2.2).
The comparison is made in float32, as the reference makes it.  The
threshold and the forced engine are device tensors the program reads (the
reference traces both), so a captured program serves every engine.

Engine codes are part of the serving ABI: 0 = empty range, 1 = Brute-L,
2 = ILCP (Sada-I-D), 3 = PDL.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import IDX
from repro_torch.core.csa import CSA, csa_search_planned
from repro_torch.core.sada import SadaCount, sada_count_batch
from repro_torch.serve.trace import stage

ENGINE_EMPTY = 0
ENGINE_BRUTE = 1
ENGINE_ILCP = 2
ENGINE_PDL = 3

#: public engine names -> forced-engine codes (-1 lets the planner decide)
ENGINE_CODES = {
    "auto": -1,
    "brute": ENGINE_BRUTE,
    "ilcp": ENGINE_ILCP,
    "pdl": ENGINE_PDL,
}


def plan_knobs(occ_df_threshold: float, engine: str, device):
    """The planner's two device inputs: (threshold float32[], forced engine
    code int32[]).  Filled on the device: no host-to-device copy."""
    return (torch.full((), occ_df_threshold, dtype=torch.float32, device=device),
            torch.full((), ENGINE_CODES[engine], dtype=IDX, device=device))


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Per-query execution plan (all int32[B] tensors)."""

    lo: torch.Tensor
    hi: torch.Tensor
    occ: torch.Tensor
    df: torch.Tensor
    engine: torch.Tensor


def plan_queries(
    csa: CSA,
    sada: SadaCount,
    patterns: torch.Tensor,     # int32[B, max_m] padded patterns
    lengths: torch.Tensor,      # int32[B] true lengths (0 = padding row)
    occ_df_threshold: torch.Tensor,  # float32[]
    forced_engine: torch.Tensor,     # int32[]: -1 = auto dispatch
) -> QueryPlan:
    """Ranges + df + occ + engine assignment.  Rows of length 0 and
    patterns with no occurrences get ``ENGINE_EMPTY``.  The stage ``plan``
    of a traced program (``serve.trace``) ends here."""
    lo, hi = csa_search_planned(csa, patterns, lengths)
    hi = torch.where(lengths > 0, hi, lo)  # padding rows: empty range
    occ = hi - lo
    df = sada_count_batch(sada, lo, hi)

    auto = torch.where(
        occ.to(torch.float32) < occ_df_threshold * torch.clamp(df, min=1).to(torch.float32),
        ENGINE_BRUTE,
        ENGINE_PDL,
    )
    engine = torch.where(forced_engine < 0, auto, forced_engine)
    engine = torch.where(occ > 0, engine, ENGINE_EMPTY).to(IDX)
    stage("plan")
    return QueryPlan(lo=lo, hi=hi, occ=occ, df=df, engine=engine)


def masked_ranges(plan: QueryPlan, engine_code: int):
    """(lo, hi) with every query not assigned to ``engine_code`` collapsed
    to the empty range (0, 0)."""
    sel = plan.engine == engine_code
    return torch.where(sel, plan.lo, 0), torch.where(sel, plan.hi, 0)
