"""Interleaved LCP (ILCP) index, listing side (counterpart of
``repro.core.ilcp``).

The ILCP array is stored run-length encoded: run starts ``L`` (a sparse
bitvector), run head values ``vilcp`` with a leftmost-min sparse-table RMQ,
and for counting a wavelet matrix over ``vilcp`` plus the value-sorted
cumulative run lengths (the paper's L').  Document listing is the Fig-1
recursion, run by the port's kernel (``repro_torch.kernels.ilcp_list``),
whose wrapper takes its plain batch-lockstep version on CPU tensors; both
report documents in discovery order.  ``ilcp_list_docs_da_batch`` is the
reference's other route to the same integers: the lockstep machine with
its RMQs sent through the batched RMQ kernel.  Sada-I-L reads DA through
the CSA, on the same kernel instantiated on the locate.
``SkewedWaveletTree`` is the reference's host oracle of Fig 2, in numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import IDX, TensorDataclass, batch_of_one, ceil_log2, elias_fano_bits
from repro_torch.core.csa import CSA
from repro_torch.core.suffix import SuffixData
from repro_torch.kernels.ilcp_list import ilcp_list, ilcp_list_plain, runs_of
from repro_torch.kernels.rmq import rmq
from repro_torch.succinct.bitvector import SparseBitvector, sparse_from_positions
from repro_torch.succinct.rmq import SparseTableRMQ, rmq_build
from repro_torch.succinct.wavelet import WaveletMatrix, wm_build, wm_rank_pair_batch


@dataclasses.dataclass(frozen=True)
class ILCPIndex(TensorDataclass):
    L: SparseBitvector          # run starts (rho ones over n)
    rmq: SparseTableRMQ         # over VILCP (leftmost-min)
    wm: WaveletMatrix           # over VILCP values
    vilcp: torch.Tensor         # int32[rho] run head values
    run_starts: torch.Tensor    # int32[rho + 1] run boundaries (last = n)
    clens: torch.Tensor         # int32[rho + 1] cum lengths, (value, pos) order
    value_run_offset: torch.Tensor  # int32[max_value + 2] first sorted run per value
    n: int
    d: int
    nruns: int
    max_value: int

    def modeled_bits_listing(self) -> int:
        """rho lg(n/rho) + O(rho) [L] + 2 rho [RMQ] + d lg(n/d) + O(d) [B]."""
        rho, n, d = self.nruns, self.n, self.d
        return (
            elias_fano_bits(rho, max(n, 1))
            + 2 * rho + max(1, rho // 4)
            + elias_fano_bits(d, max(n, 1))
        )

    def modeled_bits_counting(self) -> int:
        """rho(lg lambda + 2 lg(n/rho) + O(1)) — Theorem 2."""
        rho, n = self.nruns, self.n
        lam = max(2, self.max_value + 1)
        return rho * ceil_log2(lam) + 2 * elias_fano_bits(rho, max(n, 1)) + 2 * rho


def build_ilcp(data: SuffixData) -> ILCPIndex:
    ilcp = data.ilcp
    n = int(ilcp.shape[0])
    if n == 0:
        raise ValueError("empty collection")
    dev = ilcp.device
    change = torch.nonzero(ilcp[1:] != ilcp[:-1]).flatten().to(IDX) + 1
    run_starts = torch.cat([torch.zeros(1, dtype=IDX, device=dev), change])
    rho = int(run_starts.shape[0])
    vilcp = ilcp[run_starts].contiguous()
    run_bounds = torch.cat([run_starts, torch.full((1,), n, dtype=IDX, device=dev)])
    lengths = run_bounds[1:] - run_bounds[:-1]

    # value-sorted run lengths (the L' reordering of Section 3.4); a stable
    # sort by value keeps runs of one value in position order
    order = torch.sort(vilcp, stable=True).indices
    clens = torch.zeros(rho + 1, dtype=IDX, device=dev)
    clens[1:] = torch.cumsum(lengths[order], 0, dtype=IDX)
    max_value = int(vilcp.max())
    value_run_offset = torch.searchsorted(
        vilcp[order].contiguous(),
        torch.arange(max_value + 2, dtype=IDX, device=dev), out_int32=True,
    )
    return ILCPIndex(
        L=sparse_from_positions(run_starts, n),
        rmq=rmq_build(vilcp),
        wm=wm_build(vilcp, max_value + 1),
        vilcp=vilcp,
        run_starts=run_bounds,
        clens=clens,
        value_run_offset=value_run_offset,
        n=n,
        d=data.d,
        nruns=rho,
        max_value=max_value,
    )


def ilcp_num_runs(data: SuffixData) -> int:
    """rho, the quantity bounded by Lemma 2."""
    ilcp = data.ilcp
    if ilcp.numel() == 0:
        return 0
    return int(1 + torch.count_nonzero(ilcp[1:] != ilcp[:-1]))


def ilcp_list_docs_da_planned(index: ILCPIndex, da, lo, hi, max_df: int):
    """Sada-I-D over a range batch (masked-query contract of
    repro_torch.core.listing): (docs int32[B, max_df] padded -1, count[B]),
    documents in discovery order; the same integers as the reference's
    ``ilcp_list_docs_da_batch`` and ``ilcp_list_docs_da_planned``.  Runs
    through the listing kernel's wrapper (its plain version on CPU
    tensors)."""
    return ilcp_list(index.vilcp, index.rmq.table, index.run_starts, da,
                     lo.contiguous(), hi.contiguous(), d=index.d, max_df=max_df)


def ilcp_list_docs_da(index: ILCPIndex, da, lo, hi, max_df: int):
    """Sada-I-D for one range (ints or one-element tensors): (docs
    int32[max_df] padded -1, in discovery order; count), the listing
    kernel's wrapper over a batch of one."""
    dev = da.device
    docs, cnt = ilcp_list_docs_da_planned(index, da, batch_of_one(lo, dev),
                                          batch_of_one(hi, dev), max_df)
    return docs[0], cnt[0]


def ilcp_list_docs_csa_batch(index: ILCPIndex, csa: CSA, lo, hi, max_df: int):
    """Sada-I-L over a range batch: DA read through the CSA (locate +
    B-rank, Theorem 1's space), on the listing kernel's locate
    instantiation; the same contract as the -da variant."""
    return ilcp_list(index.vilcp, index.rmq.table, index.run_starts, csa,
                     lo.contiguous(), hi.contiguous(), d=index.d, max_df=max_df)


def ilcp_list_docs(index: ILCPIndex, source, lo, hi, max_df: int):
    """Distinct documents of DA[lo, hi) for one range (ints or one-element
    tensors) via the ILCP recursion, DA from ``source``: a stored array
    (Sada-I-D) or a CSA (Sada-I-L).  (docs int32[max_df] padded -1, in
    discovery order; count)."""
    if isinstance(source, CSA):
        dev = source.device
        docs, cnt = ilcp_list_docs_csa_batch(index, source, batch_of_one(lo, dev),
                                             batch_of_one(hi, dev), max_df)
        return docs[0], cnt[0]
    return ilcp_list_docs_da(index, source, lo, hi, max_df)


def ilcp_list_docs_csa(index: ILCPIndex, csa: CSA, lo, hi, max_df: int):
    """Sada-I-L for one range."""
    return ilcp_list_docs(index, csa, lo, hi, max_df)


def ilcp_list_docs_da_batch(index: ILCPIndex, da, lo, hi, max_df: int):
    """Sada-I-D over a range batch, kernel-routed the reference's way
    (``repro.core.ilcp.ilcp_list_docs_da_batch(use_rmq_kernel=True)``): the
    batch-lockstep POP/SCAN machine (``ilcp_list_plain``) with the
    popped-interval RMQs of every iteration sent through the batched RMQ
    kernel's wrapper, one launch per lockstep iteration.  It is not the
    fused listing kernel of ``ilcp_list_docs_da_planned``, which it equals
    integer for integer: (docs int32[B, max_df] padded -1, in discovery
    order; count[B])."""
    lo = lo.contiguous()
    hi = hi.contiguous()
    B = lo.shape[0]
    if B == 0 or max_df <= 0:
        return (torch.full((B, max(max_df, 0)), -1, dtype=IDX, device=lo.device),
                torch.zeros(B, dtype=IDX, device=lo.device))
    vilcp, table = index.vilcp, index.rmq.table

    def rmq_fn(a, b):
        return rmq(vilcp, table, a, b)

    return ilcp_list_plain(
        vilcp, table, index.run_starts, da, lo, hi,
        runs_of(index.run_starts, lo), runs_of(index.run_starts, hi - 1),
        d=index.d, max_df=max_df, rmq_fn=rmq_fn,
    )


# ---------------------------------------------------------------------------
# Document counting (Fig 3)
# ---------------------------------------------------------------------------


def ilcp_count_docs_batch(index: ILCPIndex, lo, hi, m):
    """df = |{k in [lo, hi) : ILCP[k] < m}| per query (Lemma 1; m is the
    pattern length), over int32[B] tensors.  The reference's per-value loop
    (``ilcp_count_docs``) runs for all values v < max_b min(m_b,
    max_value + 1) at once, masked to each query's own bound: per value,
    the runs of value v inside the query's runs count their lengths
    through the value-sorted cumulative lengths; the first and last run
    are then clipped to the range.  Reads the batch's largest bound on the
    host."""
    lo_run = index.L.rank1(lo + 1) - 1
    hi_run = index.L.rank1(torch.maximum(hi - 1, lo) + 1) - 1
    vmax = torch.clamp(m, max=index.max_value + 1)
    nv = int(vmax.max()) if vmax.numel() else 0
    B = lo.shape[0]
    v = torch.arange(nv, dtype=IDX, device=lo.device).expand(B, nv)
    a, b = wm_rank_pair_batch(index.wm, v, lo_run[:, None].expand(B, nv),
                              (hi_run + 1)[:, None].expand(B, nv))
    off = index.value_run_offset[v]
    per_value = index.clens[off + b] - index.clens[off + a]
    total = torch.where(v < vmax[:, None], per_value, 0).sum(1, dtype=IDX)
    # corrections: clip the first/last run to the query range
    total = total - torch.where(index.vilcp[lo_run] < m, lo - index.run_starts[lo_run], 0)
    total = total - torch.where(index.vilcp[hi_run] < m, index.run_starts[hi_run + 1] - hi, 0)
    return torch.where(lo >= hi, 0, total).to(IDX)


def ilcp_count_docs(index: ILCPIndex, lo, hi, m):
    """df of one range (ints or one-element tensors) for pattern length
    ``m``: ``ilcp_count_docs_batch`` over a batch of one."""
    dev = index.device
    return ilcp_count_docs_batch(index, batch_of_one(lo, dev), batch_of_one(hi, dev),
                                 batch_of_one(m, dev))[0]


# ---------------------------------------------------------------------------
# Host-side skewed wavelet tree (paper Fig 2) — reference + space model
# ---------------------------------------------------------------------------


class SkewedWaveletTree:
    """Host-side implementation of the Section 3.4 skewed shape: the leaf
    of value i at depth 1 + 2 floor(lg(i+1)).  The oracle of the counting
    path and of its modeled space, over numpy arrays.

    A node is (values_mask_bitvector, left, right).  Spine node S_k covers
    value groups k, k+1, ...; its left child is a balanced subtree over
    group k = values [2^{k-1}-1, 2^k-2]."""

    def __init__(self, seq, max_value: int):
        if isinstance(seq, torch.Tensor):
            seq = seq.cpu().numpy()
        self.seq = np.asarray(seq, dtype=np.int64)
        self.max_value = max_value
        self.total_bits = 0
        self.root = self._build_spine(self.seq, 1)

    def _build_spine(self, seq, group):
        if len(seq) == 0:
            return None
        lo_v = (1 << (group - 1)) - 1
        hi_v = (1 << group) - 2  # inclusive
        if lo_v > self.max_value:
            return None
        go_left = seq <= hi_v
        self.total_bits += len(seq)
        left = self._build_balanced(seq[go_left], lo_v, min(hi_v, self.max_value))
        right = self._build_spine(seq[~go_left], group + 1)
        return ("spine", go_left, left, right)

    def _build_balanced(self, seq, lo_v, hi_v):
        if len(seq) == 0 or lo_v > hi_v:
            return None
        if lo_v == hi_v:
            return ("leaf", lo_v, len(seq))
        mid = (lo_v + hi_v) // 2
        go_left = seq <= mid
        self.total_bits += len(seq)
        return (
            "node",
            go_left,
            self._build_balanced(seq[go_left], lo_v, mid),
            self._build_balanced(seq[~go_left], mid + 1, hi_v),
        )

    def count_less(self, lo: int, hi: int, m: int) -> int:
        """Occurrences of values < m in seq[lo, hi)."""

        def walk(node, lo, hi):
            if node is None or lo >= hi:
                return 0
            if node[0] == "leaf":
                return hi - lo if node[1] < m else 0
            _, go_left, left, right = node
            pref = np.cumsum(go_left)
            nl_lo = int(pref[lo - 1]) if lo > 0 else 0
            nl_hi = int(pref[hi - 1]) if hi > 0 else 0
            return walk(left, nl_lo, nl_hi) + walk(right, lo - nl_lo, hi - nl_hi)

        return walk(self.root, lo, hi)

    def modeled_bits(self) -> int:
        return self.total_bits + max(1, self.total_bits // 8)
