"""Index integrity validation — reject a corrupted index before it serves
(counterpart of ``repro.serve.validate``).

A corrupted index does not crash: succinct structures are gathers and
prefix sums, so a flipped word or a truncated offset array silently
yields wrong answers.  The validators check the invariants the query
algorithms assume and raise :class:`repro_torch.errors.IndexIntegrityError`
on the first violation, with the reference's messages:

* bitvectors: rank metadata recomputed from the words; no set bits beyond
  ``n``; sparse positions strictly increasing and in range; RLE runs
  tiling ``[0, n)``, their ones prefix decoded from the run lengths;
* wavelet matrices: per-level zero counts against the level popcounts, and
  ``sym_starts`` re-derived by the per-symbol descent of position 0;
* CSA: the C array (monotone, ``C[0] = 0``, ``C[1] = d``), the BWT's
  symbol histogram decoded from the wavelet matrix against the C array's
  deltas, SA samples in range and aligned with the sampled positions;
* ILCP: maximal runs tiling ``[0, n)``, the value-sorted cumulative
  lengths ending at ``n``, the RMQ built over the run heads;
* PDL: leaf tiling, set offsets, grammar symbol ranges, strictly
  increasing top-k frequency cumulatives;
* Sada: the unary H' encoding one 1 per slot (``plain``, ``rle``,
  ``sparse``) or per filtered slot (``filter_plain``, ``sparse_sparse``),
  and both filters well formed.

The bit-level checks run on the host copy of each array; the two
wavelet-matrix descents (``sym_starts`` and ``wm_symbol_histogram``) run
on the index's device.  ``fingerprint_service`` checksums every tensor
(CRC32 over the tensor fields in field order, recursing into nested index
objects, skipping integer metadata), so a load path can detect bit-level
corruption that keeps every invariant; the checksums of ``csa``, ``ilcp``,
``pdl_list``, ``pdl_topk``, ``sada`` (every variant) and ``da`` equal the
reference's.  ``validate_sharded_service`` validates every shard's stack
and the partition the sharded merge assumes, with fingerprints keyed
``shard{s}:{structure}``.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.common import TensorDataclass, rank1_words
from repro_torch.errors import IndexIntegrityError
from repro_torch.succinct.bitvector import PlainBitvector, RLEBitvector, SparseBitvector
from repro_torch.succinct.wavelet import WaveletMatrix


def _req(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise IndexIntegrityError(f"{name}: {msg}")


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _words(x) -> np.ndarray:
    """Bit words as unsigned 32-bit values (the port stores int32 bit
    patterns)."""
    return np.ascontiguousarray(_np(x)).view(np.uint32)


def _word_popcounts(words: np.ndarray) -> np.ndarray:
    return np.unpackbits(words.view(np.uint8)).reshape(*words.shape, 32).sum(
        axis=-1, dtype=np.int64
    )


def _unpacked_bits(words: np.ndarray) -> np.ndarray:
    """Word array -> flat 0/1 bit array, LSB-first within each 32-bit word."""
    le = np.ascontiguousarray(words).astype("<u4", copy=False).view(np.uint8)
    return np.unpackbits(le, bitorder="little")


# ---------------------------------------------------------------------------
# Bitvectors
# ---------------------------------------------------------------------------


def validate_plain_bitvector(bv: PlainBitvector, name: str) -> None:
    words, ones = _words(bv.words), _np(bv.ones_prefix)
    _req(words.shape == ones.shape, name, "words/ones_prefix shape mismatch")
    _req(words.shape[0] * 32 >= bv.n + 32, name, "missing pad word")
    pops = _word_popcounts(words)
    want = np.zeros_like(ones)
    want[1:] = np.cumsum(pops[:-1])
    _req(np.array_equal(ones, want), name, "ones_prefix != popcount prefix")
    _req(int(ones[-1]) == bv.m, name, f"m={bv.m} != total ones {int(ones[-1])}")
    _req(not _unpacked_bits(words)[bv.n:].any(), name, "set bits beyond n")
    zeros = _np(bv.zeros_prefix)
    starts = np.minimum(np.arange(len(words), dtype=np.int64) * 32, bv.n)
    _req(np.array_equal(zeros, starts - ones), name,
         "zeros_prefix inconsistent with ones_prefix")


def validate_sparse_bitvector(bv: SparseBitvector, name: str) -> None:
    pos = _np(bv.pos)
    _req(0 <= bv.m <= bv.n, name, f"m={bv.m} out of range for n={bv.n}")
    if bv.m == 0:
        return  # pos holds the [n] placeholder
    _req(pos.shape[0] == bv.m, name, f"pos has {pos.shape[0]} entries, m={bv.m}")
    _req((np.diff(pos) > 0).all() if bv.m > 1 else True, name,
         "positions not strictly increasing")
    _req(0 <= int(pos[0]) and int(pos[-1]) < bv.n, name, "position out of [0, n)")


def validate_rle_bitvector(bv: RLEBitvector, name: str) -> None:
    rs, ones = _np(bv.run_starts), _np(bv.ones_prefix)
    _req(rs.shape[0] == bv.nruns + 1 == ones.shape[0], name,
         "run_starts/ones_prefix length mismatch")
    _req(int(rs[0]) == 0 and int(rs[-1]) == bv.n, name,
         "runs do not tile [0, n)")
    _req((np.diff(rs) > 0).all() if bv.nruns else True, name,
         "empty or reordered run")
    lens = np.diff(rs)
    vals = np.bitwise_xor(np.arange(bv.nruns) & 1, bv.first_bit)
    want = np.concatenate([[0], np.cumsum(lens * vals)])
    _req(np.array_equal(ones, want), name, "ones_prefix != run decode")
    _req(int(want[-1]) == bv.m, name, f"m={bv.m} != decoded ones {int(want[-1])}")


def _validate_any_bitvector(bv, name: str) -> None:
    if isinstance(bv, PlainBitvector):
        validate_plain_bitvector(bv, name)
    elif isinstance(bv, SparseBitvector):
        validate_sparse_bitvector(bv, name)
    elif isinstance(bv, RLEBitvector):
        validate_rle_bitvector(bv, name)
    else:  # pragma: no cover - new variants must be wired in here
        raise IndexIntegrityError(f"{name}: unknown bitvector type {type(bv)}")


# ---------------------------------------------------------------------------
# Wavelet matrix
# ---------------------------------------------------------------------------


def _descend_every_symbol(wm: WaveletMatrix, pos: int) -> torch.Tensor:
    """Position ``pos`` descended along every symbol's bit path at once, on
    the index's device: int64[sigma]."""
    dev = wm.words.device
    syms = torch.arange(wm.sigma, device=dev)
    p = torch.full((wm.sigma,), pos, dtype=torch.int64, device=dev)
    for lvl in range(wm.levels):
        r1 = rank1_words(wm.words[lvl], wm.ones_prefix[lvl], p).to(torch.int64)
        p = torch.where(wm.bit_of(syms, lvl) == 0, p - r1, wm.zcount[lvl] + r1)
    return p


def validate_wavelet(wm: WaveletMatrix, name: str) -> None:
    words, prefix, zc = _words(wm.words), _np(wm.ones_prefix), _np(wm.zcount)
    _req(words.shape == prefix.shape and words.shape[0] == wm.levels, name,
         "level shape mismatch")
    _req(zc.shape[0] == wm.levels, name, "zcount length != levels")
    pops = _word_popcounts(words)
    want = np.zeros_like(prefix)
    want[:, 1:] = np.cumsum(pops[:, :-1], axis=1)
    _req(np.array_equal(prefix, want), name, "ones_prefix != popcount prefix")
    for lvl in range(wm.levels):
        _req(not _unpacked_bits(words[lvl])[wm.n:].any(), name,
             f"level {lvl}: set bits beyond n")
        total = int(prefix[lvl, -1])
        _req(int(zc[lvl]) == wm.n - total, name,
             f"level {lvl}: zcount {int(zc[lvl])} != n - ones {wm.n - total}")
    # sym_starts: the descent of position 0 that wm_build runs (rank and zero
    # counts are consistent by now, so every position stays in [0, n])
    s = _descend_every_symbol(wm, 0).cpu().numpy()
    _req(np.array_equal(_np(wm.sym_starts), s.astype(np.int32)), name,
         "sym_starts != descent of position 0 (pair-descent rank would "
         "mis-rank every query)")


def wm_symbol_histogram(wm: WaveletMatrix) -> np.ndarray:
    """Per-symbol occurrence counts decoded from the wavelet matrix alone:
    rank_c(n) = descend(n along c) - sym_starts[c], for every symbol at
    once on the index's device: int64[sigma] on the host."""
    e = _descend_every_symbol(wm, wm.n)
    return (e - wm.sym_starts.to(torch.int64)).cpu().numpy()


# ---------------------------------------------------------------------------
# Index structures
# ---------------------------------------------------------------------------


def validate_csa(csa, name: str = "csa") -> None:
    counts = _np(csa.counts)
    _req(counts.shape[0] == csa.sigma + 1, name, "C array length != sigma + 1")
    _req(int(counts[0]) == 0, name, "C[0] != 0")
    _req((np.diff(counts) >= 0).all(), name, "C array not monotone")
    _req(int(counts[-1]) <= csa.n, name, "C[sigma] > n")
    _req(int(counts[1]) == csa.d, name,
         "C[1] != d (one terminator per document)")
    validate_wavelet(csa.wm, f"{name}.wm")
    _req(csa.wm.n == csa.n and csa.wm.sigma == csa.sigma, name,
         "wavelet matrix n/sigma mismatch")
    # cross-structure check: the BWT's symbol histogram decoded from the
    # wavelet matrix must equal the C array deltas exactly
    hist = wm_symbol_histogram(csa.wm)
    _req(np.array_equal(hist, np.diff(counts).astype(np.int64)), name,
         "BWT symbol histogram != C array deltas")
    validate_sparse_bitvector(csa.sampled, f"{name}.sampled")
    validate_sparse_bitvector(csa.doc_bv, f"{name}.doc_bv")
    _req(csa.doc_bv.m == csa.d, name, "doc_bv ones != d")
    samples = _np(csa.samples)
    _req(samples.shape[0] == csa.sampled.m, name,
         "samples length != sampled positions")
    _req(samples.size == 0 or (0 <= samples.min() and samples.max() < csa.n),
         name, "SA sample out of [0, n)")


def validate_ilcp(ilcp, name: str = "ilcp") -> None:
    rho = ilcp.nruns
    bounds, vilcp, clens = _np(ilcp.run_starts), _np(ilcp.vilcp), _np(ilcp.clens)
    _req(vilcp.shape[0] == rho, name, "vilcp length != nruns")
    _req(bounds.shape[0] == rho + 1, name, "run bounds length != nruns + 1")
    _req(int(bounds[0]) == 0 and int(bounds[-1]) == ilcp.n, name,
         "runs do not tile [0, n)")
    _req((np.diff(bounds) > 0).all(), name, "empty or reordered run")
    _req(rho < 2 or bool((vilcp[1:] != vilcp[:-1]).all()), name,
         "runs not maximal (adjacent runs share a head value)")
    _req(vilcp.size == 0 or (0 <= vilcp.min() and vilcp.max() == ilcp.max_value),
         name, "vilcp values out of [0, max_value]")
    _req(clens.shape[0] == rho + 1, name, "clens length != nruns + 1")
    _req(int(clens[0]) == 0 and int(clens[-1]) == ilcp.n, name,
         "value-sorted run lengths do not sum to n")
    _req((np.diff(clens) > 0).all(), name, "clens not strictly increasing")
    vro = _np(ilcp.value_run_offset)
    _req(vro.shape[0] == ilcp.max_value + 2, name,
         "value_run_offset length != max_value + 2")
    _req(int(vro[0]) == 0 and int(vro[-1]) == rho, name,
         "value_run_offset does not cover all runs")
    _req((np.diff(vro) >= 0).all(), name, "value_run_offset not monotone")
    validate_sparse_bitvector(ilcp.L, f"{name}.L")
    _req(ilcp.L.m == rho and ilcp.L.n == ilcp.n, name,
         "L bitvector shape mismatch")
    _req(np.array_equal(_np(ilcp.L.pos), bounds[:-1]), name,
         "L ones != run starts")
    validate_wavelet(ilcp.wm, f"{name}.wm")
    _req(ilcp.wm.n == rho, name, "wavelet matrix not over the run heads")
    _req(np.array_equal(_np(ilcp.rmq.values), vilcp), name,
         "RMQ not built over the run-head values")


def validate_pdl(pdl, name: str = "pdl") -> None:
    L, I, d, nR = pdl.L, pdl.I, pdl.d, pdl.nrules  # noqa: E741
    leaf = _np(pdl.leaf_starts)
    _req(leaf.shape[0] == L + 1, name, "leaf_starts length != L + 1")
    _req(int(leaf[0]) == 0 and int(leaf[-1]) == pdl.n, name,
         "leaves do not tile the SA")
    _req((np.diff(leaf) > 0).all(), name, "empty or reordered leaf")
    soff, A = _np(pdl.set_off), _np(pdl.A)
    _req(soff.shape[0] == L + I + 1, name, "set_off length != L + I + 1")
    _req(int(soff[0]) == 0 and int(soff[-1]) == A.shape[0], name,
         "set_off does not cover A")
    _req((np.diff(soff) >= 0).all(), name, "set_off not monotone")
    _req(A.size == 0 or (0 <= A.min() and A.max() <= d + nR), name,
         "grammar symbol out of [0, d + nrules]")
    for fld in ("rule_left", "rule_right"):
        r = _np(getattr(pdl, fld))
        _req(r.size == 0 or (0 <= r.min() and r.max() <= d + nR), name,
             f"{fld} symbol out of range")
    base = _np(pdl.doc_base)
    _req(base.shape[0] == L + I + 1, name, "doc_base length != L + I + 1")
    _req(int(base[0]) == 0 and (np.diff(base) >= 0).all(), name,
         "doc_base not a prefix sum")
    nl = _np(pdl.next_leaf)
    _req(nl.size == 0 or (0 <= nl.min() and nl.max() <= L), name,
         "next_leaf out of [0, L]")
    par = _np(pdl.parent_of)
    _req(par.size == 0 or (-1 <= par.min() and par.max() < L + I), name,
         "parent_of out of range")
    if pdl.has_freqs:
        fv, gc = _np(pdl.freq_vals), _np(pdl.freq_gcum)
        _req(fv.shape == gc.shape, name, "freq_vals/freq_gcum shape mismatch")
        _req(fv.size == 0 or fv.min() >= 0, name, "negative frequency value")
        _req(gc.size == 0 or (int(gc[0]) > 0 and (np.diff(gc) > 0).all()),
             name, "freq_gcum not strictly increasing")


def validate_sada(sada, name: str = "sada") -> None:
    _req(sada.num_slots == max(0, sada.n - 1), name, "num_slots != n - 1")
    _validate_any_bitvector(sada.hp, f"{name}.hp")
    validate_sparse_bitvector(sada.fs, f"{name}.fs")
    validate_sparse_bitvector(sada.f1, f"{name}.f1")
    # the unary H' code has one 1 per encoded slot; which slots are encoded
    # depends on the variant
    if sada.variant in ("plain", "rle", "sparse"):
        _req(sada.hp.m == sada.num_slots, name, "unary H' does not encode every slot")
    else:  # filter_plain / sparse_sparse: H' restricted to the filtered slots
        _req(sada.hp.m == sada.fs.m, name, "unary H' ones != filtered slot count")


# ---------------------------------------------------------------------------
# Whole-service validation + checksums
# ---------------------------------------------------------------------------


def _tensor_leaves(obj):
    """Tensors of an index object in field order, recursing into nested
    index objects; integer metadata is skipped."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, TensorDataclass):
        for f in dataclasses.fields(obj):
            yield from _tensor_leaves(getattr(obj, f.name))


def checksum(obj) -> int:
    """Order-sensitive CRC32 over every tensor of ``obj`` (a tensor or an
    index object): bit-level identity."""
    crc = 0
    for leaf in _tensor_leaves(obj):
        crc = zlib.crc32(np.ascontiguousarray(leaf.cpu().numpy()).tobytes(), crc)
    return crc


#: the structures a service's fingerprints cover
COMPONENTS = ("csa", "ilcp", "pdl_list", "pdl_topk", "sada", "da")


def fingerprint_service(svc) -> dict:
    """Per-structure checksums of the structures the service has, for
    load-time bit-corruption detection."""
    return {comp: checksum(getattr(svc, comp)) for comp in COMPONENTS
            if getattr(svc, comp) is not None}


def verify_fingerprints(svc, expected: dict) -> None:
    got = fingerprint_service(svc)
    bad = sorted(k for k in expected if got.get(k) != expected[k])
    if bad:
        raise IndexIntegrityError(
            f"index checksum mismatch in: {', '.join(bad)} "
            "(bit-level corruption; structural invariants may still hold)"
        )


def validate_service(svc) -> dict:
    """Run every structural validator over a RetrievalService's indexes.

    Raises IndexIntegrityError on the first violated invariant; returns
    the service fingerprints when everything holds."""
    validate_csa(svc.csa)
    validate_ilcp(svc.ilcp)
    validate_pdl(svc.pdl_list, "pdl_list")
    if svc.pdl_topk is not None:
        validate_pdl(svc.pdl_topk, "pdl_topk")
    validate_sada(svc.sada)
    da = _np(svc.da)
    _req(da.size == 0 or (0 <= da.min() and da.max() < svc.coll.d), "da",
         "document-array entry out of [0, d)")
    return fingerprint_service(svc)


def validate_sharded_service(svc) -> dict:
    """Validate a ShardedRetrievalService: every shard's index stack passes
    the full structural validation, and the shards partition the
    collection as the merge algebra assumes.  Returns fingerprints keyed
    ``shard{s}:{structure}``."""
    S = svc.n_shards
    _req(S >= 1, "shards", "no shards")
    _req(len(svc.doc_bases) == S, "shards", "doc_bases length != n_shards")
    _req(int(svc.doc_bases[0]) == 0, "shards", "first shard not at doc 0")
    _req((np.diff(np.asarray(svc.doc_bases)) > 0).all() if S > 1 else True,
         "shards", "doc_bases not strictly increasing")
    total_d = 0
    total_n = 0
    fps = {}
    for s, shard in enumerate(svc.shards):
        dlo, dhi = svc.shard_doc_range(s)
        _req(shard.coll.d == dhi - dlo, f"shard{s}", "shard document count != owned range")
        _req(shard.coll.d >= 1, f"shard{s}", "empty shard (zero documents)")
        _req(shard.coll.sigma == svc.coll.sigma, f"shard{s}",
             "shard sigma != global sigma (wavelet levels would diverge)")
        # the shard's text must be the exact slice it claims to own
        base = int(svc.coll.doc_starts[dlo])
        _req(np.array_equal(_np(shard.coll.text),
                            _np(svc.coll.text)[base:base + shard.coll.n]), f"shard{s}",
             "shard text != collection slice")
        for fp_name, fp in validate_service(shard).items():
            fps[f"shard{s}:{fp_name}"] = fp
        total_d += shard.coll.d
        total_n += shard.coll.n
    _req(total_d == svc.coll.d, "shards",
         f"shard documents sum to {total_d}, collection has {svc.coll.d}")
    _req(total_n == svc.coll.n, "shards",
         f"shard texts sum to {total_n} symbols, collection has {svc.coll.n}")
    return fps
