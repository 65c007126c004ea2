"""Range-minimum queries, leftmost-minimum semantics (counterpart of
``repro.succinct.rmq``): a sparse table of argmin positions, two gathers
and one compare per query.  Ties resolve to the leftmost position, which
the listing proof (Lemma 3) depends on.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import IDX, TensorDataclass, floor_log2, floor_log2_t


@dataclasses.dataclass(frozen=True)
class SparseTableRMQ(TensorDataclass):
    """table[k, i] = argmin of values[i : i + 2^k] (leftmost).

    values: int32[n]
    table:  int32[L, n]
    """

    values: torch.Tensor
    table: torch.Tensor
    n: int
    levels: int


def argmin_table(values: torch.Tensor) -> list[torch.Tensor]:
    """Rows of the leftmost-argmin sparse table over ``values`` (int32,
    on the values' device)."""
    n = int(values.shape[0])
    levels = floor_log2(max(n, 1)) + 1
    idx = torch.arange(n, dtype=IDX, device=values.device)
    rows = [idx]
    for k in range(1, levels):
        left = rows[-1]
        right = left[torch.clamp(idx + (1 << (k - 1)), max=n - 1)]
        # leftmost tie-break: strictly less is required to move right
        rows.append(torch.where(values[right] < values[left], right, left))
    return rows


def rmq_build(values: torch.Tensor) -> SparseTableRMQ:
    values = values.to(IDX)
    n = int(values.shape[0])
    if n == 0:
        z = torch.zeros(1, dtype=IDX, device=values.device)
        return SparseTableRMQ(values=z, table=z.view(1, 1), n=0, levels=1)
    table = torch.stack(argmin_table(values))
    return SparseTableRMQ(values=values, table=table, n=n, levels=table.shape[0])


def leftmost_argmin(values, table, lo, hi):
    """Leftmost argmin of values[lo..hi] inclusive through a sparse table
    given as a [levels, n] tensor or a list of rows.  Returns lo for empty
    or inverted ranges."""
    span = torch.clamp(hi - lo + 1, min=1)
    k = torch.clamp(floor_log2_t(span), 0, len(table) - 1)
    right = torch.maximum(hi - (torch.ones_like(k) << k) + 1, lo)
    if isinstance(table, torch.Tensor):
        a = table[k, lo]
        b = table[k, right]
    else:
        a = torch.empty_like(lo)
        b = torch.empty_like(lo)
        for kk in torch.unique(k).tolist():
            sel = k == kk
            a[sel] = table[kk][lo[sel]]
            b[sel] = table[kk][right[sel]]
    va = values[a]
    vb = values[b]
    pick_b = (vb < va) | ((vb == va) & (b < a))
    return torch.where(pick_b, b, a).to(IDX)


def rmq_query(rmq: SparseTableRMQ, lo, hi):
    """Leftmost argmin of values[lo..hi] inclusive."""
    return leftmost_argmin(rmq.values, rmq.table, lo, hi)


def rmq_modeled_bits_succinct(n: int) -> int:
    """The paper's choice: Fischer-Heun 2n + o(n) bits."""
    return 2 * n + max(1, n // 4)


def rmq_modeled_bits_table(rmq: SparseTableRMQ) -> int:
    """What the working layout stores: the table and the values, 32 bits
    each."""
    return int(rmq.table.numel()) * 32 + int(rmq.values.numel()) * 32
