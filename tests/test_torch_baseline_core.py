"""The baseline listers' CUDA cores, compiled for the host.

``rt::sada_c_list_one`` (on a stored DA and on the CSA locate, one lane
playing the warp, with the kernel's shared-memory layout: ``threads``
warps per block, each its own slice), ``rt::ilcp_list_one`` on the
CSA locate (Sada-I-L; one lane playing the warp) and ``rt::wt_list_one``
of ``repro_torch/csrc/retrieval_core.cuh`` are built with g++ behind a C
shim (``test_torch_kernel_core.compile_core``) and held to the port's
plain versions on seeded collections: pattern ranges, arbitrary ranges,
(0, n), masked (0, 0) rows, at ``max_df = d + 1`` and truncating.  The WT
core also reports its pops and deepest stack: at most
max(1, count (levels + 1)) pops and levels + 1 entries, so the reference's
caps (max_df (levels + 1) + 4 entries, 4 max_df (levels + 1) + 16 pops),
which the kernel does not keep, never bind.
"""

import ctypes

import numpy as np
import pytest
import torch

from repro.core.suffix import build_suffix_data as jbuild_suffix_data
from repro.core.suffix import sa_range_for_pattern
from repro.data import collections as jcoll
from repro_torch.core.csa import build_csa
from repro_torch.core.ilcp import build_ilcp
from repro_torch.core.suffix import Collection, build_suffix_data
from repro_torch.core.wtlist import build_da_wavelet
from repro_torch.kernels.csa_view import csa_operands
from repro_torch.kernels.ilcp_list import ilcp_list_plain, runs_of, stack_cap
from repro_torch.kernels.sada_c_list import sada_c_list_plain
from repro_torch.kernels.wt_list import pop_bound, stack_size, wt_list_plain
from repro_torch.succinct.rmq import rmq_build
from test_torch_kernel_core import compile_core


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHIM = r"""
#include <vector>
#include "retrieval_core.cuh"

static rt::CsaView csa_view(const void* const* p, const int* v) {
  return rt::CsaView{
      (const int32_t*)p[0], (const int32_t*)p[1], (const int32_t*)p[2],
      (const int32_t*)p[3], (const int32_t*)p[4], (const int32_t*)p[5],
      (const int32_t*)p[6], (const int32_t*)p[7],
      v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
}

// Queries in groups of `warps`, each group's stacks and bitmaps laid out
// as the kernel's shared memory: warp w's slice at w * sada_c_shared_ints.
template <class Src>
static void sada_c_groups(const int32_t* table, const int32_t* values, const Src& src,
                          const int32_t* lo, const int32_t* hi, int32_t* docs,
                          int32_t* cnt, int B, int levels, int n, int d, int max_df,
                          int warps) {
  const int slice = rt::sada_c_shared_ints(d, max_df);
  std::vector<int32_t> smem((std::size_t)warps * slice, -7);
  for (int q = 0; q < B; ++q) {
    int32_t* s = smem.data() + (std::size_t)(q % warps) * slice;
    cnt[q] = rt::sada_c_list_one(
        table, values, levels, n, src, d, max_df, lo[q], hi[q], s,
        reinterpret_cast<uint32_t*>(s + 4 * rt::stack_cap(max_df)), docs + (long)q * max_df);
  }
}

extern "C" void core_sada_c_list(const int32_t* table, const int32_t* values,
                                 const int32_t* da, const int32_t* lo, const int32_t* hi,
                                 int32_t* docs, int32_t* cnt, int B, int levels, int n,
                                 int d, int max_df, int threads) {
  sada_c_groups(table, values, rt::DaStored{da, n}, lo, hi, docs, cnt, B, levels, n, d,
                max_df, threads);
}

extern "C" void core_sada_c_list_csa(const void* const* p, const int* v,
                                     const int32_t* table, const int32_t* values,
                                     const int32_t* lo, const int32_t* hi, int32_t* docs,
                                     int32_t* cnt, int B, int levels, int d, int max_df,
                                     int threads) {
  const rt::DaLocate src{csa_view(p, v)};
  sada_c_groups(table, values, src, lo, hi, docs, cnt, B, levels, v[2], d, max_df, threads);
}

extern "C" void core_ilcp_list_csa(const void* const* p, const int* v,
                                   const int32_t* vilcp, const int32_t* table,
                                   const int32_t* run_starts, const int32_t* lo,
                                   const int32_t* hi, int32_t* docs, int32_t* cnt, int B,
                                   int levels, int rho, int d, int max_df) {
  const rt::DaLocate src{csa_view(p, v)};
  const int cap = rt::stack_cap(max_df);
  for (int q = 0; q < B; ++q) {
    std::vector<int32_t> sa(cap), sb(cap), sr(cap);
    std::vector<uint32_t> seen((d + 31) / 32, 0xffffffffu);  // the core zeroes it
    cnt[q] = rt::ilcp_list_one(vilcp, table, run_starts, src, levels, rho, d, max_df,
                               lo[q], hi[q], rt::run_of(run_starts, rho, lo[q]),
                               rt::run_of(run_starts, rho, hi[q] - 1), sa.data(),
                               sb.data(), sr.data(), seen.data(),
                               docs + (long)q * max_df);
  }
}

extern "C" void core_wt_list(const int32_t* words, const int32_t* prefix,
                             const int32_t* zcount, const int32_t* lo, const int32_t* hi,
                             int32_t* docs, int32_t* freqs, int32_t* cnt, int32_t* pops,
                             int32_t* depth, int B, int levels, int stride, int max_df) {
  for (int q = 0; q < B; ++q) {
    int p = 0, s = 0;
    cnt[q] = rt::wt_list_one(words, prefix, zcount, levels, stride, lo[q], hi[q], max_df,
                             docs + (long)q * max_df, freqs + (long)q * max_df, &p, &s);
    pops[q] = p;
    depth[q] = s;
  }
}
"""

SPECS = {
    "version": jcoll.SyntheticSpec("version", n_base=3, n_variants=7, base_len=90,
                                   mutation_rate=0.01, seed=5),
    "dna": jcoll.paperlike_collections(0.05)["dna-p001"],
}


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return compile_core(SHIM, tmp_path_factory.mktemp("baseline_core"))


def _p(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


class _Csa:
    """The CSA's view as the shim reads it (arrays kept alive)."""

    def __init__(self, csa):
        tensors, ints = csa_operands(csa)
        self.arrays = [np.ascontiguousarray(t.numpy()) for _, t, _ in tensors]
        self.ptrs = (ctypes.c_void_p * len(self.arrays))(*(a.ctypes.data for a in self.arrays))
        self.ints = (ctypes.c_int * len(ints))(*ints)


@pytest.fixture(scope="module", params=list(SPECS))
def idx(request):
    coll = jcoll.generate(SPECS[request.param])
    jdata = jbuild_suffix_data(coll)
    tdata = build_suffix_data(Collection(text=coll.text, doc_starts=coll.doc_starts,
                                         doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma),
                              "cpu")
    ranges = [sa_range_for_pattern(jdata, p)
              for p in jcoll.random_substring_patterns(coll, 200, 1, 24, seed=6)]
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, coll.n + 1, 12), rng.integers(0, coll.n + 1, 12)
    ranges += list(zip(np.minimum(a, b), np.maximum(a, b)))
    ranges += [(0, 0), (0, coll.n), (0, 0), (coll.n - 1, coll.n)]
    csa = build_csa(tdata)
    return dict(
        n=coll.n, d=coll.d, da=tdata.da, csa=csa, view=_Csa(csa), ilcp=build_ilcp(tdata),
        rmq=rmq_build(tdata.c), wm=build_da_wavelet(tdata.da, coll.d),
        lo=np.asarray([r[0] for r in ranges], np.int32),
        hi=np.asarray([r[1] for r in ranges], np.int32),
    )


def _np32(t):
    return np.ascontiguousarray(t.numpy().astype(np.int32))


@pytest.mark.parametrize("source", ["da", "csa"])
@pytest.mark.parametrize("max_df,threads", [(None, 1), (None, 3), (2, 3)])
def test_core_sada_c_list(core, idx, source, max_df, threads):
    d = idx["d"]
    max_df = max_df or d + 1
    lo, hi = idx["lo"], idx["hi"]
    B = len(lo)
    table, values = _np32(idx["rmq"].table), _np32(idx["rmq"].values)
    levels = table.shape[0]
    docs = np.full((B, max_df), 99, np.int32)
    cnt = np.zeros(B, np.int32)
    if source == "da":
        core.core_sada_c_list(_p(table), _p(values), _p(_np32(idx["da"])), _p(lo), _p(hi),
                              _p(docs), _p(cnt), B, levels, idx["n"], d, max_df, threads)
        src = idx["da"]
    else:
        v = idx["view"]
        core.core_sada_c_list_csa(v.ptrs, v.ints, _p(table), _p(values), _p(lo), _p(hi),
                                  _p(docs), _p(cnt), B, levels, d, max_df, threads)
        src = idx["csa"]
    want_docs, want_cnt = sada_c_list_plain(idx["rmq"].values, idx["rmq"].table, src,
                                            torch.from_numpy(lo), torch.from_numpy(hi),
                                            d=d, max_df=max_df)
    np.testing.assert_array_equal(cnt, want_cnt.numpy())
    np.testing.assert_array_equal(docs, want_docs.numpy())


@pytest.mark.parametrize("max_df", [None, 2])
def test_core_ilcp_list_csa(core, idx, max_df):
    """Sada-I-L's core (the warp core on the locate, one lane playing the
    warp) against the plain version on the CSA source, and Sada-I-D's."""
    d = idx["d"]
    max_df = max_df or d + 1
    lo, hi = idx["lo"], idx["hi"]
    B = len(lo)
    il = idx["ilcp"]
    table = _np32(il.rmq.table)
    levels, rho = table.shape
    docs = np.full((B, max_df), 99, np.int32)
    cnt = np.zeros(B, np.int32)
    v = idx["view"]
    core.core_ilcp_list_csa(v.ptrs, v.ints, _p(_np32(il.vilcp)), _p(table),
                            _p(_np32(il.run_starts)), _p(lo), _p(hi), _p(docs), _p(cnt), B,
                            levels, rho, d, max_df)
    tlo, thi = torch.from_numpy(lo), torch.from_numpy(hi)
    args = (il.vilcp, il.rmq.table, il.run_starts)
    runs = (runs_of(il.run_starts, tlo), runs_of(il.run_starts, thi - 1))
    for src in (idx["csa"], idx["da"]):
        want_docs, want_cnt = ilcp_list_plain(*args, src, tlo, thi, *runs, d=d, max_df=max_df)
        np.testing.assert_array_equal(cnt, want_cnt.numpy())
        np.testing.assert_array_equal(docs, want_docs.numpy())


@pytest.mark.parametrize("max_df", [None, 1, 3])
def test_core_wt_list(core, idx, max_df):
    d = idx["d"]
    max_df = max_df or d + 1
    lo, hi = idx["lo"], idx["hi"]
    B = len(lo)
    wm = idx["wm"]
    words, prefix, zcount = _np32(wm.words), _np32(wm.ones_prefix), _np32(wm.zcount)
    levels, stride = words.shape
    docs = np.full((B, max_df), 99, np.int32)
    freqs = np.full((B, max_df), 99, np.int32)
    cnt, pops, depth = (np.zeros(B, np.int32) for _ in range(3))
    core.core_wt_list(_p(words), _p(prefix), _p(zcount), _p(lo), _p(hi), _p(docs), _p(freqs),
                      _p(cnt), _p(pops), _p(depth), B, levels, stride, max_df)
    want = wt_list_plain(wm.words, wm.ones_prefix, wm.zcount, torch.from_numpy(lo),
                         torch.from_numpy(hi), max_df=max_df)
    for got, w in zip((docs, freqs, cnt), want):
        np.testing.assert_array_equal(got, w.numpy())
    # the pop and stack bounds that let the kernel drop the reference's caps
    bound = np.asarray([pop_bound(levels, int(c)) for c in cnt])
    assert (pops <= bound).all(), (pops - bound).max()
    assert (depth <= levels + 1).all() and depth.max() == levels + 1
    assert stack_size(levels) == levels + 2
    assert (pops < 4 * max_df * (levels + 1) + 16).all()
    assert (depth < max_df * (levels + 1) + 4).all()
    # the bound is reached: a query whose every leaf costs a full descent
    full = (lo == 0) & (hi == idx["n"])
    assert (pops[full] > cnt[full]).all()


def test_stack_cap_is_the_references():
    assert stack_cap(10) == 14
