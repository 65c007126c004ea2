"""Wavelet-tree document listing (Valimaki & Makinen 2007; the WT baseline
of Navarro et al. 2014, Section 6.2.1 of the paper), counterpart of
``repro.core.wtlist``.

The document array DA is stored in a wavelet matrix; the distinct documents
of DA[lo, hi) are enumerated by walking only the nodes whose interval is
non-empty, left first, so they come out ascending, each with its range
frequency (hi' - lo' at the leaf), which is why WT also answers top-k.
The walk runs in the port's kernel (``repro_torch.kernels.wt_list``), one
launch per batch; the single-range forms are the batch functions over a
batch of one.
"""

from __future__ import annotations

from repro_torch.common import batch_of_one
from repro_torch.core.listing import brute_topk_batch
from repro_torch.kernels.wt_list import wt_list
from repro_torch.succinct.wavelet import WaveletMatrix, wm_build, wm_modeled_bits


def build_da_wavelet(da, d: int) -> WaveletMatrix:
    """The wavelet matrix of DA over the alphabet [0, d), on DA's device."""
    return wm_build(da, d)


def wt_list_docs_batch(wm: WaveletMatrix, lo, hi, max_df: int):
    """Distinct documents (+ frequencies) of DA[lo, hi) over a range batch
    (int32[B] each): (docs int32[B, max_df] ascending, -1 padded; freqs
    int32[B, max_df]; count int32[B])."""
    return wt_list(wm.words, wm.ones_prefix, wm.zcount, lo.contiguous(), hi.contiguous(),
                   max_df=max_df)


def wt_list_docs(wm: WaveletMatrix, lo, hi, max_df: int):
    """One range (ints or one-element tensors): (docs int32[max_df],
    freqs int32[max_df], count)."""
    dev = wm.words.device
    docs, freqs, cnt = wt_list_docs_batch(wm, batch_of_one(lo, dev), batch_of_one(hi, dev),
                                          max_df)
    return docs[0], freqs[0], cnt[0]


def wt_topk_batch(wm: WaveletMatrix, lo, hi, k: int, max_df: int):
    """Top-k by frequency from the WT lister (tf desc, doc asc), over a
    range batch: (docs int32[B, k] padded -1, tf int32[B, k])."""
    docs, freqs, cnt = wt_list_docs_batch(wm, lo, hi, max_df)
    return brute_topk_batch(docs, cnt, freqs, k)


def wt_topk(wm: WaveletMatrix, lo, hi, k: int, max_df: int):
    """Top-k of one range: (docs int32[k] padded -1, tf int32[k])."""
    dev = wm.words.device
    docs, tf = wt_topk_batch(wm, batch_of_one(lo, dev), batch_of_one(hi, dev), k, max_df)
    return docs[0], tf[0]


def wt_modeled_bits(wm: WaveletMatrix) -> int:
    """n lg d + o(n lg d): the WT-over-DA baseline's space."""
    return wm_modeled_bits(wm)
