"""The warp-per-query Sada-C core's parts, compiled for the host.

``rt::group_search`` (the half-warp's 16-way search, one lane playing the
group's lanes), ``rt::csa_locate_group`` / ``rt::DaLocate::group`` and
``rt::sada_c_list_one`` of ``repro_torch/csrc/retrieval_core.cuh`` are
built with g++ behind a C shim (``test_torch_kernel_core.compile_core``):
the group search against ``rt::lower_bound`` / ``rt::upper_bound`` and
``numpy.searchsorted``, the group locate against ``rt::csa_locate_one`` at
every position of a small CSA, the listing core on both DA sources against
``sada_c_list_plain``, and the recursion's two caps, which never end a
query.
"""

import numpy as np
import pytest
import torch

from repro.core.suffix import build_suffix_data as jbuild_suffix_data
from repro.core.suffix import sa_range_for_pattern
from repro.data import collections as jcoll
from repro_torch.core.csa import build_csa
from repro_torch.core.suffix import Collection, build_suffix_data
from repro_torch.kernels.ilcp_list import pop_cap, stack_cap
from repro_torch.kernels.sada_c_list import sada_c_list_plain
from repro_torch.succinct.rmq import rmq_build
from test_torch_baseline_core import _Csa, _np32, _p
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

extern "C" void core_group_search(const int32_t* a, int len, const int32_t* xs, int nx,
                                  int lanes, int upper, int32_t* got, int32_t* at,
                                  int32_t* want) {
  for (int i = 0; i < nx; ++i) {
    got[i] = upper ? rt::group_search<true>(a, len, xs[i], 0, lanes, at + i)
                   : rt::group_search<false>(a, len, xs[i], 0, lanes, at + i);
    want[i] = upper ? rt::upper_bound(a, len, xs[i]) : rt::lower_bound(a, len, xs[i]);
  }
}

extern "C" void core_locate(const void* const* p, const int* v, int32_t* one,
                            int32_t* group, int32_t* doc_one, int32_t* doc_group) {
  const rt::CsaView c = csa_view(p, v);
  const rt::DaLocate src{c};
  for (int i = 0; i < c.n; ++i) {
    one[i] = rt::csa_locate_one(c, i);
    group[i] = rt::csa_locate_group(c, i, 0, rt::kHalf);
    doc_one[i] = src(i);
    doc_group[i] = src.group(i, 0, rt::kHalf);
  }
}

// Queries in groups of `warps`, each warp's slice of the kernel's shared
// memory its own (filled with garbage: the core zeroes its bitmap).
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

extern "C" void core_sada_c(const void* const* p, const int* v, const int32_t* da,
                            const int32_t* table, const int32_t* values, const int32_t* lo,
                            const int32_t* hi, int32_t* docs, int32_t* cnt, int B,
                            int levels, int d, int max_df, int warps) {
  if (da) {
    sada_c_groups(table, values, rt::DaStored{da, v[2]}, lo, hi, docs, cnt, B, levels, v[2],
                  d, max_df, warps);
  } else {
    sada_c_groups(table, values, rt::DaLocate{csa_view(p, v)}, lo, hi, docs, cnt, B, levels,
                  v[2], d, max_df, warps);
  }
}
"""

WARPS = 4


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return compile_core(SHIM, tmp_path_factory.mktemp("sada_c_warp"))


@pytest.fixture(scope="module")
def idx():
    spec = jcoll.SyntheticSpec("version", n_base=3, n_variants=7, base_len=90,
                               mutation_rate=0.01, seed=11)
    coll = jcoll.generate(spec)
    jdata = jbuild_suffix_data(coll)
    tdata = build_suffix_data(Collection(text=coll.text, doc_starts=coll.doc_starts,
                                         doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma),
                              "cpu")
    ranges = [sa_range_for_pattern(jdata, p)
              for p in jcoll.random_substring_patterns(coll, 60, 1, 12, seed=12)]
    ranges += [(0, 0), (0, coll.n), (0, 0), (coll.n - 1, coll.n)]
    csa = build_csa(tdata)
    return dict(n=coll.n, d=coll.d, da=tdata.da, csa=csa, view=_Csa(csa),
                rmq=rmq_build(tdata.c), lo=np.asarray([r[0] for r in ranges], np.int32),
                hi=np.asarray([r[1] for r in ranges], np.int32))


@pytest.mark.parametrize("lanes", [16, 2, 32])
@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("length", [0, 1, 16, 17, 1 << 16])
def test_group_search(core, length, upper, lanes):
    """The group search gives lower_bound's (upper_bound's) index, and the
    entry at it, on sorted arrays with duplicates, for x below, inside and
    above the array."""
    rng = np.random.default_rng(length + 7)
    a = np.sort(rng.integers(-5, max(length // 3, 2), length)).astype(np.int32)
    lo_v, hi_v = (int(a[0]), int(a[-1])) if length else (0, 0)
    xs = np.concatenate([[lo_v - 3, lo_v - 1, hi_v + 1, hi_v + 9], a,
                         rng.integers(lo_v - 2, hi_v + 3, 64)]).astype(np.int32)
    got, at, want = (np.zeros(len(xs), np.int32) for _ in range(3))
    core.core_group_search(_p(a), length, _p(xs), len(xs), lanes, int(upper), _p(got), _p(at),
                           _p(want))
    np.testing.assert_array_equal(got, np.searchsorted(a, xs, "right" if upper else "left"))
    np.testing.assert_array_equal(got, want)
    inside = got < length
    np.testing.assert_array_equal(at[inside], a[got[inside]])


def test_locate_group(core, idx):
    """``csa_locate_group`` equals ``csa_locate_one`` at every position of
    a small CSA, and ``DaLocate::group`` the one-thread locate's document,
    which is DA."""
    n, v = idx["n"], idx["view"]
    one, group, doc_one, doc_group = (np.zeros(n, np.int32) for _ in range(4))
    core.core_locate(v.ptrs, v.ints, _p(one), _p(group), _p(doc_one), _p(doc_group))
    np.testing.assert_array_equal(group, one)
    np.testing.assert_array_equal(doc_group, doc_one)
    np.testing.assert_array_equal(doc_one, idx["da"].numpy())
    assert sorted(one.tolist()) == list(range(n))


def _run_core(core, idx, source, max_df, lo, hi):
    table, values = _np32(idx["rmq"].table), _np32(idx["rmq"].values)
    B = len(lo)
    docs = np.full((B, max_df), 99, np.int32)
    cnt = np.zeros(B, np.int32)
    da = _np32(idx["da"]) if source == "da" else None
    v = idx["view"]
    core.core_sada_c(v.ptrs, v.ints, None if da is None else _p(da), _p(table), _p(values),
                     _p(lo), _p(hi), _p(docs), _p(cnt), B, table.shape[0], idx["d"], max_df,
                     WARPS)
    return docs, cnt


@pytest.mark.parametrize("source", ["da", "csa"])
@pytest.mark.parametrize("max_df", [1, 2, None])
def test_core_against_plain(core, idx, source, max_df):
    """The warp core (one lane playing the warp, children resolved at push
    time) on both sources equals the plain version at ``max_df`` 1, 2 and
    d + 1, masked (0, 0) rows and (0, n) included."""
    max_df = max_df or idx["d"] + 1
    lo, hi = idx["lo"], idx["hi"]
    docs, cnt = _run_core(core, idx, source, max_df, lo, hi)
    src = idx["da"] if source == "da" else idx["csa"]
    want_docs, want_cnt = sada_c_list_plain(idx["rmq"].values, idx["rmq"].table, src,
                                            torch.from_numpy(lo), torch.from_numpy(hi),
                                            d=idx["d"], max_df=max_df)
    np.testing.assert_array_equal(cnt, want_cnt.numpy())
    np.testing.assert_array_equal(docs, want_docs.numpy())
    assert cnt[-4] == cnt[-2] == 0 and cnt[-3] == min(max_df, idx["d"])


def _replay(values, da, a0, b0, max_df):
    """The reference's recursion for one range, with its pops and deepest
    stack: (docs, pops, depth)."""
    n = len(values)
    stack, seen, out, pops, depth = [(a0, b0 - 1)], set(), [], 0, 1
    while stack and len(out) < max_df and pops < pop_cap(max_df):
        a, b = stack.pop()
        pops += 1
        if a > b or a0 >= b0:
            continue
        x, y = min(max(min(a, b0 - 1), 0), n - 1), min(max(min(b, b0 - 1), 0), n - 1)
        k = x + int(np.argmin(values[x:y + 1]))
        g = int(da[k])
        if g in seen:
            continue
        seen.add(g)
        out.append(g)
        for c in ((k + 1, b), (a, k - 1)):
            if c[0] <= c[1] and len(stack) < stack_cap(max_df):
                stack.append(c)
        depth = max(depth, len(stack))
    return out, pops, depth


@pytest.mark.parametrize("max_df", [3, None])
def test_caps_never_end_a_query(core, idx, max_df):
    """Only a reported pop pushes, at most two children, so a query that
    has reported c documents has popped at most 2 c + 1 intervals and held
    at most c + 1: while c < max_df that stays under pop_cap (2 max_df + 8)
    and stack_cap (max_df + 4).  A query ends on an empty stack or at
    max_df, never at either cap, whatever its pruned pops.  Shown on every
    range with the reference's recursion replayed (its rows equal the
    core's), the whole collection (0, n) included."""
    max_df = max_df or idx["d"] + 1
    lo, hi = idx["lo"], idx["hi"]
    values = idx["rmq"].values.numpy()
    docs, cnt = _run_core(core, idx, "csa", max_df, lo, hi)
    pruned = 0
    for q, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
        out, pops, depth = _replay(values, idx["da"].numpy(), a, b, max_df)
        assert out == docs[q, :cnt[q]].tolist()
        assert pops <= 2 * len(out) + 1 < pop_cap(max_df)
        assert depth <= len(out) + 1 <= stack_cap(max_df)
        pruned += pops - len(out) - (a >= b)
    # the untruncated run prunes; the truncated one stops at max_df
    assert pruned > 0 if max_df > idx["d"] else cnt.max() == max_df
