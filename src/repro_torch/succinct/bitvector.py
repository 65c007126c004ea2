"""Rank/select bitvectors (counterpart of ``repro.succinct.bitvector``).

* ``PlainBitvector``  — int32 bit-pattern words + popcount prefix.
* ``SparseBitvector`` — positions of the 1s (Elias-Fano modeled size).

Conventions (0-based, half-open):
  rank1(bv, i)   = number of 1s in positions [0, i),   0 <= i <= n
  select1(bv, j) = position of the j-th 1 (j in [0, m)); n when out of range
Every query takes and returns int32 tensors of any shape.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import (
    IDX,
    WORD_BITS,
    TensorDataclass,
    ceil_div,
    elias_fano_bits,
    i32_bits,
    popcount32,
    rank1_words,
    searchsorted_i32,
    u32,
)

# ---------------------------------------------------------------------------
# Plain bitvector
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlainBitvector(TensorDataclass):
    """words:        int32[W+1] bit patterns (one zero pad word)
    ones_prefix:  int32[W+1] ones in words [0, w)
    zeros_prefix: int32[W+1] zeros in positions [0, 32*w) clamped to n
    """

    words: torch.Tensor
    ones_prefix: torch.Tensor
    zeros_prefix: torch.Tensor
    n: int
    m: int

    def rank1(self, i):
        return rank1_words(self.words, self.ones_prefix, i)

    def get(self, i):
        i = i.to(torch.int64)
        return ((u32(self.words[i >> 5]) >> (i & 31)) & 1).to(IDX)

    def select1(self, j):
        """Position of the j-th 1 (j in [0, m)).  Out-of-range j returns n."""
        w = searchsorted_i32(self.ones_prefix, j, right=True) - 1
        w = torch.clamp(w, 0, self.words.shape[0] - 1)
        local = j - self.ones_prefix[w]
        shifts = torch.arange(WORD_BITS, device=j.device)
        bits = (u32(self.words[w]).unsqueeze(-1) >> shifts) & 1
        cum = torch.cumsum(bits, -1)
        pos_in_word = torch.argmax((cum == (local.unsqueeze(-1) + 1)).to(IDX), -1).to(IDX)
        ok = (j >= 0) & (j < self.m)
        return torch.where(ok, w * WORD_BITS + pos_in_word, self.n).to(IDX)

    def modeled_bits(self) -> int:
        """Paper-model size: n + o(n) (plain bitvector with rank support)."""
        return self.n + ceil_div(self.n, WORD_BITS * 8) * WORD_BITS + 2 * WORD_BITS


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 tensor -> unsigned 32-bit words held in int64 (little-endian
    within a word)."""
    n = bits.shape[0]
    W = ceil_div(max(n, 1), WORD_BITS)
    padded = torch.zeros(W * WORD_BITS, dtype=torch.int64, device=bits.device)
    padded[:n] = bits.to(torch.int64)
    shifts = torch.arange(WORD_BITS, device=bits.device)
    return (padded.view(W, WORD_BITS) << shifts).sum(1)


def plain_from_bits(bits: torch.Tensor) -> PlainBitvector:
    n = int(bits.shape[0])
    words = pack_bits(bits)
    dev = words.device
    pc = torch.zeros(words.shape[0] + 1, dtype=torch.int64, device=dev)
    pc[1:] = torch.cumsum(popcount32(words), 0)
    word_start = torch.clamp(
        torch.arange(words.shape[0] + 1, device=dev) * WORD_BITS, max=n
    )
    return PlainBitvector(
        words=torch.cat([i32_bits(words), torch.zeros(1, dtype=IDX, device=dev)]),
        ones_prefix=pc.to(IDX),
        zeros_prefix=(word_start - pc).to(IDX),
        n=n,
        m=int(pc[-1]),
    )


# ---------------------------------------------------------------------------
# Sparse bitvector (Elias-Fano model)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseBitvector(TensorDataclass):
    """pos: int32[m] sorted positions of the 1s (``[n]`` if m == 0)."""

    pos: torch.Tensor
    n: int
    m: int

    def rank1(self, i):
        return searchsorted_i32(self.pos, i)

    def get(self, i):
        k = torch.clamp(searchsorted_i32(self.pos, i), 0, max(self.m - 1, 0))
        return ((self.pos[k] == i) & (self.m > 0)).to(IDX)

    def select1(self, j):
        ok = (j >= 0) & (j < self.m)
        jc = torch.clamp(j, 0, max(self.m - 1, 0))
        return torch.where(ok, self.pos[jc], self.n).to(IDX)

    def modeled_bits(self) -> int:
        return elias_fano_bits(self.m, self.n)


def sparse_from_positions(pos: torch.Tensor, n: int) -> SparseBitvector:
    """``pos`` must be strictly increasing and inside [0, n)."""
    pos = pos.to(IDX)
    m = int(pos.shape[0])
    store = pos if m else torch.full((1,), n, dtype=IDX, device=pos.device)
    return SparseBitvector(pos=store.contiguous(), n=int(n), m=m)
