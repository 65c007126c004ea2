"""Sadakane's document-counting structure, ``"sparse"`` variant (Sada-S of
Section 6.4.1; counterpart of ``repro.core.sada``).

H[k] counts the redundant suffixes charged to LCP slot k: every adjacent
same-document pair (c[j], j) is charged to the leftmost minimum of
LCP[c[j]+1 .. j].  The unary code of the slots (one 1 per slot, then H[k]
0s) is stored as a sparse bitvector, and a range's

    df = (hi - lo) - (select1(hi-1) - (hi-1)) + (select1(lo) - lo).

The argmin table over LCP is built on the device in int32.  The other
encodings (plain, rle, sparse_sparse, filter_plain) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import IDX, TensorDataclass
from repro_torch.core.suffix import SuffixData
from repro_torch.succinct.bitvector import SparseBitvector, sparse_from_positions
from repro_torch.succinct.rmq import argmin_table, leftmost_argmin

VARIANTS = ("sparse",)


def compute_h_slots(data: SuffixData) -> torch.Tensor:
    """H[k] for slots k in [1, n) (H[0] = 0), int32 on the data's device."""
    n = data.n
    c = data.c
    j = torch.nonzero(c >= 0).flatten().to(IDX)
    if j.shape[0] == 0:
        return torch.zeros(n, dtype=IDX, device=c.device)
    i = c[j]
    k = leftmost_argmin(data.lcp, argmin_table(data.lcp), i + 1, j)
    H = torch.bincount(k.long(), minlength=n).to(IDX)
    H[0] = 0
    return H


@dataclasses.dataclass(frozen=True)
class SadaCount(TensorDataclass):
    """hp: the unary H' bitvector (positions of its ones)."""

    hp: SparseBitvector
    n: int
    variant: str
    num_slots: int

    def modeled_bits(self) -> int:
        return self.hp.modeled_bits()


def build_sada(data: SuffixData, variant: str = "sparse") -> SadaCount:
    if variant not in VARIANTS:
        raise ValueError(f"Sada variant {variant!r} is not ported (have {VARIANTS})")
    slots = compute_h_slots(data)[1:].to(torch.int64)
    num_slots = int(slots.shape[0])
    # the t-th one of the unary code sits at t + (sum of the first t slots)
    pos = torch.zeros(num_slots, dtype=torch.int64, device=slots.device)
    if num_slots:
        pos[1:] = torch.cumsum(slots[:-1] + 1, 0)
    total = num_slots + int(slots.sum())
    return SadaCount(hp=sparse_from_positions(pos, total), n=data.n,
                     variant=variant, num_slots=num_slots)


def sada_count_batch(s: SadaCount, lo, hi):
    """df for the locus ranges [lo, hi) (int32[B] each)."""
    a = lo  # stored slot t <-> slot id t + 1; slots in (lo, hi)
    b = hi - 1
    dup = (s.hp.select1(b) - b) - (s.hp.select1(a) - a)
    return torch.where(hi > lo, (hi - lo) - dup, 0).to(IDX)
