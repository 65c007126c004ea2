"""Sadakane's document-counting structure and the five encodings of
Section 6.4.1 (counterpart of ``repro.core.sada``).

H[k] counts the redundant suffixes charged to LCP slot k: every adjacent
same-document pair (c[j], j) is charged to the leftmost minimum of
LCP[c[j]+1 .. j].  The unary code of the slots (one 1 per slot, then H[k]
0s) answers a range's

    df = (hi - lo) - (select1(hi-1) - (hi-1)) + (select1(lo) - lo).

The encodings (``VARIANTS``) wrap the same H values:

* ``plain``         — Sada: plain bitvector H' (``build_sada``'s default);
* ``rle``           — Sada-RR: run-length encoded H';
* ``sparse``        — Sada-S: sparse H' (what the service builds);
* ``sparse_sparse`` — Sada-S-S: sparse H' over the H > 1 slots, a sparse
  filter F_S marking them and a sparse 1-filter F_1 marking H == 1;
* ``filter_plain``  — Sada-F-P: a sparse filter F_S marking H > 0 and a
  plain H' over those slots.

``fs`` and ``f1`` hold a one-entry placeholder where the variant does not
use them, as the reference's do.  The argmin table over LCP and every
bitvector are built on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import IDX, TensorDataclass, batch_of_one
from repro_torch.core.suffix import SuffixData
from repro_torch.succinct.bitvector import (
    PlainBitvector,
    RLEBitvector,
    SparseBitvector,
    plain_from_bits,
    rle_from_bits,
    sparse_from_bits,
    sparse_from_positions,
    unary_bits,
)
from repro_torch.succinct.rmq import argmin_table, leftmost_argmin

VARIANTS = ("plain", "rle", "sparse", "sparse_sparse", "filter_plain")


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
    """One of the Section 6.4.1 encodings of Sadakane's structure.

    hp: the unary H' bitvector (full, or restricted per the variant)
    fs: sparse filter over slots (H > 0 for filter_plain, H > 1 for
        sparse_sparse; a placeholder otherwise)
    f1: sparse 1-filter, H == 1 (sparse_sparse; a placeholder otherwise)
    """

    hp: PlainBitvector | RLEBitvector | SparseBitvector
    fs: SparseBitvector
    f1: SparseBitvector
    n: int
    variant: str
    num_slots: int

    def modeled_bits(self) -> int:
        bits = self.hp.modeled_bits()
        if self.variant in ("sparse_sparse", "filter_plain"):
            bits += self.fs.modeled_bits()
        if self.variant == "sparse_sparse":
            bits += self.f1.modeled_bits()
        return bits


def _dummy_sparse(n: int, device) -> SparseBitvector:
    """The placeholder of an unused filter: no ones over max(n, 1)."""
    return sparse_from_positions(torch.zeros(0, dtype=IDX, device=device), max(n, 1))


def _filter(mask: torch.Tensor, n: int) -> SparseBitvector:
    """Slots where ``mask`` holds, as positions of slot ids (slot t of
    ``mask`` is slot id t + 1) over n."""
    return sparse_from_positions(torch.nonzero(mask).flatten() + 1, n)


def build_sada(data: SuffixData, variant: str = "plain") -> SadaCount:
    if variant not in VARIANTS:
        raise ValueError(f"unknown Sada variant {variant!r} (have {VARIANTS})")
    n = data.n
    dev = data.device
    slots = compute_h_slots(data)[1:].to(torch.int64)
    fs = f1 = _dummy_sparse(n, dev)
    if variant == "plain":
        hp = plain_from_bits(unary_bits(slots))
    elif variant == "rle":
        hp = rle_from_bits(unary_bits(slots))
    elif variant == "sparse":
        hp = sparse_from_bits(unary_bits(slots))
    elif variant == "filter_plain":
        fs = _filter(slots > 0, n)
        hp = plain_from_bits(unary_bits(slots[slots > 0]))
    else:  # sparse_sparse
        fs = _filter(slots > 1, n)
        f1 = _filter(slots == 1, n)
        hp = sparse_from_bits(unary_bits(slots[slots > 1]))
    return SadaCount(hp=hp, fs=fs, f1=f1, n=n, variant=variant,
                     num_slots=int(slots.shape[0]))


def _unary_prefix_sum(hp, t):
    """Sum of the first t unary-coded values = select1(t) - t (select1 of
    an out-of-range t returns the bitvector's length, which keeps the
    identity)."""
    return hp.select1(t) - t


def sada_count_batch(s: SadaCount, lo, hi):
    """df for the locus ranges [lo, hi) (int32[B] each), exact for
    suffix-tree-node-aligned ranges.  Slot ids in (lo, hi) are counted;
    the static ``variant`` picks the query form."""
    a = lo + 1
    b = hi
    if s.variant in ("plain", "rle", "sparse"):
        # stored slot t <-> slot id t + 1
        dup = _unary_prefix_sum(s.hp, b - 1) - _unary_prefix_sum(s.hp, a - 1)
    else:
        a_, b_ = s.fs.rank1(a), s.fs.rank1(b)
        dup = _unary_prefix_sum(s.hp, b_) - _unary_prefix_sum(s.hp, a_)
        if s.variant == "sparse_sparse":
            dup = dup + s.f1.rank1(b) - s.f1.rank1(a)
    return torch.where(hi > lo, (hi - lo) - dup, 0).to(IDX)


def sada_count(s: SadaCount, lo, hi):
    """df for one locus range [lo, hi) (ints or one-element tensors):
    ``sada_count_batch`` over a batch of one, as a 0-d int32 tensor."""
    dev = s.device
    return sada_count_batch(s, batch_of_one(lo, dev), batch_of_one(hi, dev))[0]


def hprime_runs_of_ones(data: SuffixData) -> int:
    """Runs of 1s in the unary H' of every slot (the Fig 5 analysis)."""
    bits = unary_bits(compute_h_slots(data)[1:])
    if bits.numel() == 0:
        return 0
    starts = (bits[1:] == 1) & (bits[:-1] == 0)
    return int(starts.sum()) + int(bits[0] == 1)
