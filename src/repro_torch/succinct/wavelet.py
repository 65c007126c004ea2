"""Wavelet matrix over small-alphabet sequences (counterpart of
``repro.succinct.wavelet``).

Built on the device: one stable partition and one packed bitvector per
level.  ``sym_starts[c]`` is the descent of position 0 along c's bits, so
``rank_c(S, i) = descend(i) - sym_starts[c]`` costs one rank per level.
Conventions: sequence values in [0, sigma); ranks half-open.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import IDX, TensorDataclass, batch_of_one, ceil_log2, rank1_words, u32
from repro_torch.kernels.rank import rank
from repro_torch.succinct.bitvector import plain_from_bits


@dataclasses.dataclass(frozen=True)
class WaveletMatrix(TensorDataclass):
    """words:       int32[L, W+1] bit patterns; level 0 tests the MSB
    ones_prefix: int32[L, W+1]
    zcount:      int32[L]      zeros at each level
    sym_starts:  int32[sigma]  block start of each symbol at the bottom
    """

    words: torch.Tensor
    ones_prefix: torch.Tensor
    zcount: torch.Tensor
    sym_starts: torch.Tensor
    n: int
    sigma: int
    levels: int

    def rank1_level(self, lvl: int, i):
        return rank1_words(self.words[lvl], self.ones_prefix[lvl], i)

    def bit_of(self, c, lvl: int):
        return (c >> (self.levels - 1 - lvl)) & 1


def wm_build(seq: torch.Tensor, sigma: int | None = None) -> WaveletMatrix:
    seq = seq.to(torch.int64)
    n = int(seq.shape[0])
    if sigma is None:
        sigma = int(seq.max()) + 1 if n else 1
    levels = max(1, ceil_log2(max(sigma, 2)))
    cur = seq
    words_l, prefix_l, zc = [], [], []
    for lvl in range(levels):
        bits = (cur >> (levels - 1 - lvl)) & 1
        bv = plain_from_bits(bits)
        words_l.append(bv.words)
        prefix_l.append(bv.ones_prefix)
        zc.append(n - bv.m)
        cur = torch.cat([cur[bits == 0], cur[bits == 1]])  # stable partition
    words = torch.stack(words_l)
    prefix = torch.stack(prefix_l)

    # per-symbol block starts: descend position 0 for every c at once
    syms = torch.arange(sigma, device=seq.device)
    s = torch.zeros(sigma, dtype=IDX, device=seq.device)
    for lvl in range(levels):
        bit = (syms >> (levels - 1 - lvl)) & 1
        r1 = rank1_words(words[lvl], prefix[lvl], s)
        s = torch.where(bit == 0, s - r1, zc[lvl] + r1)
    return WaveletMatrix(
        words=words,
        ones_prefix=prefix,
        zcount=torch.tensor(zc, dtype=IDX, device=seq.device),
        sym_starts=s.to(IDX),
        n=n,
        sigma=int(sigma),
        levels=levels,
    )


def wm_descend(wm: WaveletMatrix, c, i):
    """Descend position(s) ``i`` along symbol ``c``'s bit path."""
    for lvl in range(wm.levels):
        r1 = wm.rank1_level(lvl, i)
        i = torch.where(wm.bit_of(c, lvl) == 0, i - r1, wm.zcount[lvl] + r1)
    return i


def wm_rank(wm: WaveletMatrix, c, i):
    """rank_c(S, i): occurrences of symbol c in S[0, i), elementwise."""
    return (wm_descend(wm, c, i) - wm.sym_starts[c]).to(IDX)


def wm_rank_batch(wm: WaveletMatrix, c, i):
    """Batched rank_c(S, i) over int32[B] symbols (in [0, sigma)) and
    positions, through the batched rank kernel's wrapper (counterpart of
    the reference's ``wm_rank_batch(use_kernel=True)``): at each level the
    two prefix ranks of the block start and the mapped position go as one
    [lo; hi] stream of 2B queries, one launch per level."""
    B = i.shape[0]
    lo = torch.zeros(B, dtype=IDX, device=i.device)
    hi = i.to(IDX)
    for lvl in range(wm.levels):
        bit = wm.bit_of(c, lvl)
        z = wm.zcount[lvl]
        r1 = rank(wm.words[lvl], wm.ones_prefix[lvl], torch.cat([lo, hi]))
        lo = torch.where(bit == 0, lo - r1[:B], z + r1[:B])
        hi = torch.where(bit == 0, hi - r1[B:], z + r1[B:])
    return (hi - lo).to(IDX)


def wm_rank_pair_batch(wm: WaveletMatrix, c, lo, hi):
    """(rank_c(S, lo), rank_c(S, hi)): both positions ride one descent
    along c's bit path.  c must be in [0, sigma)."""
    for lvl in range(wm.levels):
        bit = wm.bit_of(c, lvl)
        z = wm.zcount[lvl]
        r1p = wm.rank1_level(lvl, lo)
        r1q = wm.rank1_level(lvl, hi)
        lo = torch.where(bit == 0, lo - r1p, z + r1p)
        hi = torch.where(bit == 0, hi - r1q, z + r1q)
    start = wm.sym_starts[c]
    return (lo - start).to(IDX), (hi - start).to(IDX)


def wm_rank_pair(wm: WaveletMatrix, c, lo, hi):
    """(rank_c(S, lo), rank_c(S, hi)) for one symbol and two positions
    (ints or one-element tensors): ``wm_rank_pair_batch`` over a batch of
    one, as 0-d int32 tensors."""
    dev = wm.words.device
    a, b = wm_rank_pair_batch(wm, batch_of_one(c, dev), batch_of_one(lo, dev),
                              batch_of_one(hi, dev))
    return a[0], b[0]


def wm_symbol_range(wm: WaveletMatrix, c, lo, hi):
    """Occurrence-rank interval (a, b) of symbol c within S[lo, hi): its
    occurrences there are the a-th .. (b-1)-th of c in the whole sequence
    (the skewed-tree counting of Section 3.4).  Both ends are the ranks of
    ``wm_rank_pair``."""
    return wm_rank_pair(wm, c, lo, hi)


def wm_access(wm: WaveletMatrix, i):
    """S[i], elementwise."""
    pos = i
    val = torch.zeros_like(i)
    for lvl in range(wm.levels):
        p64 = pos.to(torch.int64)
        bit = ((u32(wm.words[lvl][p64 >> 5]) >> (p64 & 31)) & 1).to(IDX)
        r1 = wm.rank1_level(lvl, pos)
        pos = torch.where(bit == 0, pos - r1, wm.zcount[lvl] + r1)
        val = (val << 1) | bit
    return val


def wm_count_less(wm: WaveletMatrix, lo, hi, m):
    """Number of positions p in [lo, hi) with S[p] < m, elementwise over
    equal-shape int32 tensors.  Both range ends ride one descent along m's
    bit path: where m's bit is 1, the block of values with a 0 there (same
    prefix, so all < m) is counted, and the descent goes right."""
    acc = torch.zeros_like(lo)
    p, q = lo, hi
    for lvl in range(wm.levels):
        bit = wm.bit_of(m, lvl)
        p0 = p - wm.rank1_level(lvl, p)
        q0 = q - wm.rank1_level(lvl, q)
        acc = acc + torch.where(bit == 1, q0 - p0, 0)
        p = torch.where(bit == 0, p0, wm.zcount[lvl] + (p - p0))
        q = torch.where(bit == 0, q0, wm.zcount[lvl] + (q - q0))
    return torch.where(m >= wm.sigma, hi - lo, acc).to(IDX)


def wm_modeled_bits(wm: WaveletMatrix) -> int:
    """n*ceil(lg sigma) + o(...) — plain-bitvector levels."""
    per_level = wm.n + max(1, wm.n // 8)
    return wm.levels * per_level + 64 * wm.levels
