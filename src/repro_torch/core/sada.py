"""Sadakane's document-counting structure, ``"plain"`` (Sada) and
``"sparse"`` (Sada-S) variants of Section 6.4.1 (counterpart of
``repro.core.sada``).

H[k] counts the redundant suffixes charged to LCP slot k: every adjacent
same-document pair (c[j], j) is charged to the leftmost minimum of
LCP[c[j]+1 .. j].  The unary code of the slots (one 1 per slot, then H[k]
0s) is stored as a plain bitvector with rank support (``"plain"``, the
default, as the reference's) or a sparse one (``"sparse"``, what the
service builds), and a range's

    df = (hi - lo) - (select1(hi-1) - (hi-1)) + (select1(lo) - lo).

The argmin table over LCP is built on the device in int32.  The other
encodings (rle, sparse_sparse, filter_plain) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import IDX, TensorDataclass, batch_of_one
from repro_torch.core.suffix import SuffixData
from repro_torch.succinct.bitvector import (
    PlainBitvector,
    SparseBitvector,
    plain_from_bits,
    sparse_from_positions,
)
from repro_torch.succinct.rmq import argmin_table, leftmost_argmin

VARIANTS = ("plain", "sparse")


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
    """hp: the unary H' bitvector, plain or sparse per ``variant``."""

    hp: PlainBitvector | SparseBitvector
    n: int
    variant: str
    num_slots: int

    def modeled_bits(self) -> int:
        return self.hp.modeled_bits()


def build_sada(data: SuffixData, variant: str = "plain") -> SadaCount:
    if variant not in VARIANTS:
        raise ValueError(f"Sada variant {variant!r} is not ported (have {VARIANTS})")
    slots = compute_h_slots(data)[1:].to(torch.int64)
    num_slots = int(slots.shape[0])
    # the t-th one of the unary code sits at t + (sum of the first t slots)
    pos = torch.zeros(num_slots, dtype=torch.int64, device=slots.device)
    if num_slots:
        pos[1:] = torch.cumsum(slots[:-1] + 1, 0)
    total = num_slots + int(slots.sum())
    if variant == "plain":
        bits = torch.zeros(total, dtype=torch.uint8, device=slots.device)
        bits[pos] = 1
        hp = plain_from_bits(bits)
    else:
        hp = sparse_from_positions(pos, total)
    return SadaCount(hp=hp, n=data.n, variant=variant, num_slots=num_slots)


def sada_count_batch(s: SadaCount, lo, hi):
    """df for the locus ranges [lo, hi) (int32[B] each)."""
    a = lo  # stored slot t <-> slot id t + 1; slots in (lo, hi)
    b = hi - 1
    dup = (s.hp.select1(b) - b) - (s.hp.select1(a) - a)
    return torch.where(hi > lo, (hi - lo) - dup, 0).to(IDX)


def sada_count(s: SadaCount, lo, hi):
    """df for one locus range [lo, hi) (ints or one-element tensors):
    ``sada_count_batch`` over a batch of one, as a 0-d int32 tensor."""
    dev = s.device
    return sada_count_batch(s, batch_of_one(lo, dev), batch_of_one(hi, dev))[0]
