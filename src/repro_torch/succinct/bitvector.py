"""Rank/select bitvectors (counterpart of ``repro.succinct.bitvector``).

* ``PlainBitvector``  — int32 bit-pattern words + popcount prefix.
* ``SparseBitvector`` — positions of the 1s (Elias-Fano modeled size).
* ``RLEBitvector``    — alternating runs, rank/select by binary search over
  the run starts and the ones before each run (delta-coded modeled size:
  the Sada-RR encoding of Section 6.4.1).

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
    floor_log2_t,
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


def sparse_from_bits(bits: torch.Tensor) -> SparseBitvector:
    """The positions of the 1s of a 0/1 tensor as a sparse bitvector."""
    return sparse_from_positions(torch.nonzero(bits).flatten(), int(bits.shape[0]))


# ---------------------------------------------------------------------------
# Run-length encoded bitvector
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RLEBitvector(TensorDataclass):
    """Alternating runs; run r covers [run_starts[r], run_starts[r+1]) and
    holds the bit ``first_bit ^ (r & 1)``.

    run_starts:  int32[R+1] (last entry == n)
    ones_prefix: int32[R+1] ones in runs [0, r)
    """

    run_starts: torch.Tensor
    ones_prefix: torch.Tensor
    n: int
    m: int
    first_bit: int
    nruns: int

    def _run_of(self, i):
        r = searchsorted_i32(self.run_starts, i, right=True) - 1
        return torch.clamp(r, 0, self.nruns - 1)

    def rank1(self, i):
        """Ones in [0, i); 0 for i <= 0."""
        r = torch.where(i <= 0, 0, self._run_of(torch.clamp(i - 1, min=0)))
        within = torch.where(((r & 1) ^ self.first_bit) == 1, i - self.run_starts[r], 0)
        return torch.where(i <= 0, 0, self.ones_prefix[r] + within).to(IDX)

    def rank0(self, i):
        return (i - self.rank1(i)).to(IDX)

    def get(self, i):
        return ((self._run_of(i) & 1) ^ self.first_bit).to(IDX)

    def select1(self, j):
        """Position of the j-th 1; n when j is outside [0, m)."""
        r = torch.clamp(searchsorted_i32(self.ones_prefix, j, right=True) - 1,
                        0, self.nruns - 1)
        pos = self.run_starts[r] + (j - self.ones_prefix[r])
        return torch.where((j >= 0) & (j < self.m), pos, self.n).to(IDX)

    def select0(self, j):
        """Position of the j-th 0; n when j is outside [0, n - m)."""
        if self.n == 0:  # no runs to search (the reference's gather raises)
            return torch.zeros_like(j, dtype=IDX)
        zeros_prefix = (self.run_starts[:-1] - self.ones_prefix[:-1]).contiguous()
        r = torch.clamp(searchsorted_i32(zeros_prefix, j, right=True) - 1,
                        0, self.nruns - 1)
        pos = self.run_starts[r] + (j - zeros_prefix[r])
        return torch.where((j >= 0) & (j < self.n - self.m), pos, self.n).to(IDX)

    def modeled_bits(self) -> int:
        """Delta-coded run lengths + 64 (the Sada-RR encoding of Section
        6.4.1), summed on the device."""
        lens = (self.run_starts[1:] - self.run_starts[:-1]).to(torch.int64)
        lens = lens[lens > 0]
        if lens.numel() == 0:
            return 2 * WORD_BITS
        lg = floor_log2_t(lens).to(torch.int64)
        delta = 2 * floor_log2_t(lg + 1).to(torch.int64) + 1 + lg
        return int(delta.sum()) + 2 * WORD_BITS


def rle_from_bits(bits: torch.Tensor) -> RLEBitvector:
    """Runs of a 0/1 tensor, on its device."""
    n = int(bits.shape[0])
    dev = bits.device
    if n == 0:
        z = torch.zeros(1, dtype=IDX, device=dev)
        return RLEBitvector(run_starts=z, ones_prefix=z.clone(), n=0, m=0,
                            first_bit=0, nruns=1)
    bits = bits.to(torch.int64)
    change = torch.nonzero(bits[1:] != bits[:-1]).flatten() + 1
    run_starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), change,
                            torch.full((1,), n, dtype=torch.int64, device=dev)])
    first_bit = int(bits[0])
    nruns = int(run_starts.shape[0]) - 1
    lens = run_starts[1:] - run_starts[:-1]
    run_vals = (torch.arange(nruns, device=dev) & 1) ^ first_bit
    ones_prefix = torch.zeros(nruns + 1, dtype=torch.int64, device=dev)
    ones_prefix[1:] = torch.cumsum(lens * run_vals, 0)
    return RLEBitvector(run_starts=run_starts.to(IDX), ones_prefix=ones_prefix.to(IDX),
                        n=n, m=int(ones_prefix[-1]), first_bit=first_bit, nruns=nruns)


def unary_bits(values: torch.Tensor) -> torch.Tensor:
    """The unary code of non-negative ints: a 1, then v 0s, per value
    (uint8 on the values' device)."""
    values = values.to(torch.int64)
    k = int(values.shape[0])
    bits = torch.zeros(k + int(values.sum()), dtype=torch.uint8, device=values.device)
    if k:
        pos = torch.zeros(k, dtype=torch.int64, device=values.device)
        pos[1:] = torch.cumsum(values[:-1] + 1, 0)
        bits[pos] = 1
    return bits
