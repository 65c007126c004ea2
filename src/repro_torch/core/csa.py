"""Compressed suffix array: FM-index over a BWT wavelet matrix (counterpart
of ``repro.core.csa``).

* ``search``: batched backward search through the port's kernel
  (``repro_torch.kernels.backward_search``); the reference's pair descent
  stays as a CPU-only cross-check;
* ``lookup``: SA[i] by LF-walking to a sampled position.  Every text
  position that is a multiple of ``sample_rate`` is sampled, so a walk
  takes fewer than ``sample_rate`` LF steps: the batched walk runs exactly
  ``sample_rate`` masked rounds and never syncs with the host.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import IDX, TensorDataclass, arange_i32, as_i32, batch_of_one, ceil_log2
from repro_torch.core.suffix import SuffixData
from repro_torch.succinct.bitvector import SparseBitvector, sparse_from_positions
from repro_torch.succinct.wavelet import WaveletMatrix, wm_access, wm_build, wm_rank


@dataclasses.dataclass(frozen=True)
class CSA(TensorDataclass):
    wm: WaveletMatrix          # wavelet matrix over the BWT
    counts: torch.Tensor       # int32[sigma+1]: symbols strictly < c
    sampled: SparseBitvector   # SA positions i whose SA[i] is sampled
    samples: torch.Tensor      # int32[s]: SA[i] for sampled i, in SA order
    doc_bv: SparseBitvector    # text positions of document starts
    n: int
    d: int
    sigma: int
    sample_rate: int
    bwt_runs: int

    def modeled_bits_rlcsa(self) -> int:
        """rho(lg sigma + 2 lg(n/rho)) + samples — the RLCSA model."""
        rho = max(1, self.bwt_runs)
        per_run = ceil_log2(self.sigma) + 2 * max(1, ceil_log2(max(2, self.n // rho)))
        sample_bits = int(self.samples.shape[0]) * ceil_log2(max(2, self.n))
        return rho * per_run + sample_bits


def build_csa(data: SuffixData, sample_rate: int = 16) -> CSA:
    coll = data.coll
    n, d = coll.n, coll.d
    dev = data.device
    sa = data.sa
    text = as_i32(coll.text, dev)
    bwt = text[(sa.to(torch.int64) - 1) % n]
    wm = wm_build(bwt, coll.sigma)

    hist = torch.bincount(text, minlength=coll.sigma + 1)
    counts = torch.zeros(coll.sigma + 1, dtype=IDX, device=dev)
    counts[1:] = torch.cumsum(hist, 0)[:-1].to(IDX)

    doc_starts = as_i32(coll.doc_starts, dev)
    text_sampled = (sa % sample_rate == 0) | torch.isin(sa, doc_starts)
    marked = torch.nonzero(text_sampled).flatten().to(IDX)
    runs = int(1 + torch.count_nonzero(bwt[1:] != bwt[:-1])) if n else 0
    return CSA(
        wm=wm,
        counts=counts,
        sampled=sparse_from_positions(marked, n),
        samples=sa[marked].contiguous(),
        doc_bv=sparse_from_positions(doc_starts, n),
        n=n,
        d=d,
        sigma=coll.sigma,
        sample_rate=sample_rate,
        bwt_runs=runs,
    )


# ---------------------------------------------------------------------------
# search(m): backward search (batched)
# ---------------------------------------------------------------------------


def csa_symbol_bounds(csa: CSA, c):
    """Input hardening for one backward-search step: the clamped symbol,
    the validity mask, and the collapse point (0 below the alphabet, n
    above it)."""
    c_ok = (c >= 0) & (c < csa.sigma)
    cc = torch.clamp(c, 0, csa.sigma - 1)
    oob = torch.where(c < 0, 0, csa.n).to(IDX)
    return cc, c_ok, oob


def search_base(csa: CSA) -> torch.Tensor:
    """``base[c] = counts[c] - sym_starts[c]``: the kernel's per-symbol
    offset, so each range end costs one rank per level."""
    return (csa.counts[: csa.sigma] - csa.wm.sym_starts).contiguous()


def csa_search_planned(csa: CSA, patterns, lengths):
    """SA ranges [lo, hi) of a padded pattern batch (int32[B, max_m],
    lengths int32[B]), through the backward-search kernel's wrapper (which
    runs the kernel's plain version on CPU tensors)."""
    from repro_torch.kernels.backward_search import backward_search

    wm = csa.wm
    return backward_search(
        wm.words, wm.ones_prefix, wm.zcount, search_base(csa),
        patterns.contiguous(), lengths.contiguous(), n=csa.n, sigma=csa.sigma,
    )


#: the reference's per-query search over a batch (``csa_search_batch``)
#: gives the same integers: here it is the kernel-routed search itself
csa_search_batch = csa_search_planned


def csa_search(csa: CSA, pattern, length):
    """SA range [lo, hi) of the suffixes prefixed by ``pattern[:length]``
    (``pattern``: int32[max_m], padded): ``csa_search_planned`` over a
    batch of one, as 0-d int32 tensors."""
    dev = csa.device
    lo, hi = csa_search_planned(csa, as_i32(pattern, dev).reshape(1, -1),
                                batch_of_one(length, dev))
    return lo[0], hi[0]


def csa_search_pairs(csa: CSA, patterns, lengths):
    """The same ranges by the reference's pair descent over the wavelet
    matrix (``wm_rank_pair_batch``): a CPU cross-check of the kernel's
    plain version.  Raises on CUDA tensors, where the search runs only
    through the kernel."""
    if patterns.is_cuda:
        raise ValueError("csa_search_pairs runs on CPU tensors only; "
                         "use csa_search_planned on the card")
    from repro_torch.succinct.wavelet import wm_rank_pair_batch

    B, max_m = patterns.shape
    rows = torch.arange(B, device=patterns.device)
    lo = torch.zeros(B, dtype=IDX, device=patterns.device)
    hi = torch.full((B,), csa.n, dtype=IDX, device=patterns.device)
    for t in range(max_m):
        j = torch.clamp(lengths - 1 - t, 0, max_m - 1).long()
        active = (t < lengths) & (lo < hi)
        cc, c_ok, oob = csa_symbol_bounds(csa, patterns[rows, j])
        rlo, rhi = wm_rank_pair_batch(csa.wm, cc, lo, hi)
        base = csa.counts[cc]
        lo = torch.where(active, torch.where(c_ok, base + rlo, oob), lo)
        hi = torch.where(active, torch.where(c_ok, base + rhi, oob), hi)
    return lo, torch.maximum(lo, hi)


# ---------------------------------------------------------------------------
# lookup(n): locate SA[i] by LF-walk to a sample (batched)
# ---------------------------------------------------------------------------


def _lf(csa: CSA, j):
    c = wm_access(csa.wm, j)
    return csa.counts[c] + wm_rank(csa.wm, c, j)


def csa_lookup(csa: CSA, i):
    """SA[i] for an int32 tensor of SA positions (any shape)."""
    j = i
    steps = torch.zeros_like(i)
    done = torch.zeros(i.shape, dtype=torch.bool, device=i.device)
    for _ in range(csa.sample_rate):
        done = done | (csa.sampled.get(j) == 1)
        j = torch.where(done, j, _lf(csa, j))
        steps = torch.where(done, steps, steps + 1)
    return (csa.samples[csa.sampled.rank1(j)] + steps).to(IDX)


def csa_doc_of(csa: CSA, text_pos):
    """DA[i] given SA[i]: rank over the document-start bitvector B."""
    return csa.doc_bv.rank1(text_pos + 1) - 1


#: SA[i] over a tensor of positions (the reference's vmapped form)
csa_lookup_batch = csa_lookup


def csa_da_at(csa: CSA, i):
    """DA[i] = rank_B(SA[i]): the Sadakane replacement for a stored DA,
    elementwise over an int32 tensor of SA positions."""
    return csa_doc_of(csa, csa_lookup(csa, i))


def csa_locate_range(csa: CSA, lo, max_out: int):
    """SA[lo : lo + max_out] for one start ``lo`` (int or one-element
    tensor), clamped to n - 1 (the caller masks against hi): int32[max_out]."""
    idx = batch_of_one(lo, csa.device) + arange_i32(max_out, csa.device)
    return csa_lookup(csa, torch.clamp(idx, max=csa.n - 1))


def doc_at(source, k):
    """DA[k] from a DA source, elementwise over int32 positions (clamped
    into [0, n)): a stored document array (int32[n]) or a CSA (locate, then
    rank over the document starts)."""
    if isinstance(source, CSA):
        return csa_da_at(source, torch.clamp(k, 0, source.n - 1)).to(IDX)
    return source[torch.clamp(k, 0, source.shape[0] - 1).long()]
