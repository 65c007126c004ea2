"""The CUDA kernels' per-query core, compiled for the host.

``repro_torch/csrc/retrieval_core.cuh`` holds the logic of the Hopper
kernels as ``__host__ __device__`` functions.  Here a host C++ compiler
builds it (outside ``__CUDACC__`` the header maps ``__popc``/``__clz`` to
the compiler builtins) behind a small C shim, and its integers are held
against the port's plain versions and the JAX reference on the inputs of
``test_torch_kernels.py`` and ``test_torch_primitives.py``.  This is the only check of the kernels' logic
that runs without the card.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.succinct.wavelet import wm_build as jax_wm_build
from repro_torch.kernels.backward_search import backward_search_plain, reverse_patterns
from repro_torch.kernels.ilcp_list import ilcp_list_plain, runs_of
from repro_torch.kernels.rank import rank_plain
from repro_torch.kernels.rmq import rmq_plain
from test_torch_primitives import rank_case, rmq_case


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

SHIM = r"""
#include <vector>
#include "retrieval_core.cuh"

extern "C" void core_backward_search(
    const int32_t* words, const int32_t* prefix, const int32_t* zcount,
    const int32_t* base, const int32_t* patterns, const int32_t* lengths,
    int32_t* lo, int32_t* hi, int B, int max_m, int levels, int stride,
    int n, int sigma) {
  for (int q = 0; q < B; ++q)
    rt::backward_search_one(words, prefix, zcount, base, levels, stride, n,
                            sigma, patterns + (long)q * max_m, max_m,
                            lengths[q], lo + q, hi + q);
}

extern "C" void core_ilcp_list(
    const int32_t* vilcp, const int32_t* table, const int32_t* run_starts,
    const int32_t* da, const int32_t* lo, const int32_t* hi,
    const int32_t* lo_run, const int32_t* hi_run, int32_t* docs,
    int32_t* cnt, int B, int levels, int rho, int n, int d, int max_df) {
  const int cap = rt::stack_cap(max_df);
  for (int q = 0; q < B; ++q) {
    std::vector<int32_t> sa(cap), sb(cap), sr(cap);
    std::vector<uint32_t> seen((d + 31) / 32, 0xffffffffu);  // the core zeroes it
    cnt[q] = rt::ilcp_list_one(vilcp, table, run_starts, da, levels, rho, n,
                               d, max_df, lo[q], hi[q], lo_run[q], hi_run[q],
                               sa.data(), sb.data(), sr.data(), seen.data(),
                               docs + (long)q * max_df);
  }
}

extern "C" void core_run_of(const int32_t* run_starts, int rho,
                            const int32_t* pos, int32_t* out, int Q) {
  for (int q = 0; q < Q; ++q) out[q] = rt::run_of(run_starts, rho, pos[q]);
}

extern "C" void core_rank(const int32_t* words, const int32_t* prefix,
                          const int32_t* idx, int32_t* out, int Q) {
  for (int q = 0; q < Q; ++q) out[q] = rt::wm_rank1(words, prefix, 0, 0, idx[q]);
}

extern "C" void core_rmq(const int32_t* values, const int32_t* table,
                         const int32_t* lo, const int32_t* hi, int32_t* out,
                         int Q, int levels, int rho) {
  for (int q = 0; q < Q; ++q)
    out[q] = rt::rmq_leftmost(table, values, levels, rho, lo[q], hi[q]);
}
"""


def compile_core(shim: str, out: Path) -> ctypes.CDLL:
    """Build ``shim`` (C++ that includes ``retrieval_core.cuh``) with g++
    into a shared library in ``out`` and load it; skip without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel core")
    src = out / "shim.cpp"
    src.write_text(shim)
    lib = out / "libcore.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(CSRC),
         "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return compile_core(SHIM, tmp_path_factory.mktemp("core"))


def _p(a: np.ndarray):
    assert a.dtype == np.int32 and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


def _bws_inputs(n, sigma, Q, max_m, seed):
    """A wavelet matrix over a random sequence, its FM-index base array
    and padded patterns with length-0 rows and out-of-alphabet symbols."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, sigma, n)
    wm = jax_wm_build(seq, sigma)
    counts = np.concatenate([[0], np.cumsum(np.bincount(seq, minlength=sigma))])
    base = (counts[:sigma] - np.asarray(wm.sym_starts)).astype(np.int32)
    pats = np.zeros((Q, max_m), np.int32)
    lens = rng.integers(0, max_m + 1, Q).astype(np.int32)
    for qi in range(Q):
        m = int(lens[qi])
        if m and rng.random() < 0.5:
            start = rng.integers(0, n - m + 1)
            pats[qi, :m] = seq[start : start + m]
        elif m:
            pats[qi, :m] = rng.integers(0, sigma, m)
        if m and rng.random() < 0.3:
            pats[qi, rng.integers(0, m)] = rng.choice([-1, sigma, -7, sigma + 3])
    return (np.array(wm.words).view(np.int32), np.array(wm.ones_prefix),
            np.array(wm.zcount), base, pats, lens)


@pytest.mark.parametrize("sigma,Q,max_m", [(2, 1, 9), (5, 33, 9), (37, 64, 8), (5, 4, 0)])
def test_core_backward_search(core, sigma, Q, max_m):
    n = 500
    words, prefix, zcount, base, pats, lens = _bws_inputs(n, sigma, Q, max_m, sigma + Q)
    lo = np.zeros(Q, np.int32)
    hi = np.zeros(Q, np.int32)
    core.core_backward_search(
        _p(words), _p(prefix), _p(zcount), _p(base), _p(pats), _p(lens), _p(lo), _p(hi),
        Q, max_m, words.shape[0], words.shape[1], n, sigma,
    )
    tl, th = backward_search_plain(
        *(torch.from_numpy(a) for a in (words, prefix, zcount, base)),
        reverse_patterns(torch.from_numpy(pats), torch.from_numpy(lens)),
        torch.from_numpy(lens), n=n, sigma=sigma,
    )
    np.testing.assert_array_equal(lo, tl.numpy())
    np.testing.assert_array_equal(hi, th.numpy())
    if max_m:
        rev = reverse_patterns(torch.from_numpy(pats), torch.from_numpy(lens)).numpy()
        rl, rh = ref.backward_search_ref(
            jnp.asarray(words.view(np.uint32)), jnp.asarray(prefix), jnp.asarray(zcount),
            jnp.asarray(base), jnp.asarray(rev), jnp.asarray(lens), n=n, sigma=sigma,
        )
        np.testing.assert_array_equal(lo, np.asarray(rl))
        np.testing.assert_array_equal(hi, np.asarray(rh))


def _ilcp_inputs():
    from repro.core.ilcp import build_ilcp
    from repro.core.suffix import build_suffix_data, sa_range_for_pattern
    from repro.data.collections import SyntheticSpec, generate, random_substring_patterns

    coll = generate(SyntheticSpec("version", n_base=2, n_variants=6, base_len=80,
                                  mutation_rate=0.02, seed=13))
    data = build_suffix_data(coll)
    index = build_ilcp(data)
    ranges = [sa_range_for_pattern(data, p)
              for p in random_substring_patterns(coll, 300, 5, 32)]
    ranges += [(0, 0), (5, 5), (7, 3), (0, coll.n)]
    lo = np.asarray([r[0] for r in ranges], np.int32)
    hi = np.asarray([r[1] for r in ranges], np.int32)
    arrays = [np.array(x) for x in (index.vilcp, index.rmq.table, index.run_starts, data.da)]
    return coll.d, arrays, lo, hi


@pytest.mark.parametrize("max_df", [1, 2, 8, 64, 31, 33, 300])
def test_core_ilcp_list(core, max_df):
    """The warp core (run here as one lane playing the warp's 32 in turn:
    DA positions tested in chunks of 32 against the bitmap and each other,
    argmins resolved at push time); max_df 31, 33 and 300 cut a run's
    scan inside and at the edges of a chunk, or not at all."""
    d, (vilcp, table, run_starts, da), lo, hi = _ilcp_inputs()
    t = [torch.from_numpy(a) for a in (vilcp, table, run_starts, da, lo, hi)]
    lo_run = runs_of(t[2], t[4])
    hi_run = runs_of(t[2], t[5] - 1)
    hi_run[-2] = -1  # a padded row: invalid root interval
    B = lo.shape[0]
    docs = np.zeros((B, max_df), np.int32)
    cnt = np.zeros(B, np.int32)
    levels, rho = table.shape
    core.core_ilcp_list(
        _p(vilcp), _p(table), _p(run_starts), _p(da), _p(lo), _p(hi),
        _p(lo_run.numpy()), _p(hi_run.numpy()), _p(docs), _p(cnt),
        B, levels, rho, da.shape[0], d, max_df,
    )
    pd, pc = ilcp_list_plain(*t, lo_run, hi_run, d=d, max_df=max_df)
    np.testing.assert_array_equal(cnt, pc.numpy())
    np.testing.assert_array_equal(docs, pd.numpy())
    rd, rc = ref.ilcp_list_ref(
        *(jnp.asarray(a) for a in (vilcp, table, run_starts, da, lo, hi)),
        jnp.asarray(lo_run.numpy()), jnp.asarray(hi_run.numpy()), d=d, max_df=max_df,
    )
    np.testing.assert_array_equal(cnt, np.asarray(rc))
    np.testing.assert_array_equal(docs, np.asarray(rd))


def test_core_run_of(core):
    """The kernel's root runs: ``runs_of`` for every position, -1 and n."""
    _, (_, _, run_starts, da), _, _ = _ilcp_inputs()
    n, rho = da.shape[0], run_starts.shape[0] - 1
    pos = np.arange(-1, n + 1, dtype=np.int32)
    out = np.zeros_like(pos)
    core.core_run_of(_p(run_starts), rho, _p(pos), _p(out), pos.shape[0])
    want = runs_of(torch.from_numpy(run_starts), torch.from_numpy(pos))
    np.testing.assert_array_equal(out, want.numpy())


@pytest.mark.parametrize("W,Q", [(1, 3), (5, 40), (70, 500)])
def test_core_rank(core, W, Q):
    words, prefix, idx = rank_case(W, Q, seed=W + Q)
    words = words.view(np.int32)
    out = np.zeros(idx.shape[0], np.int32)
    core.core_rank(_p(words), _p(prefix), _p(idx), _p(out), idx.shape[0])
    want = rank_plain(torch.from_numpy(words), torch.from_numpy(prefix), torch.from_numpy(idx))
    np.testing.assert_array_equal(out, want.numpy())


@pytest.mark.parametrize("rho,Q,distinct", [(1, 2, 1), (2, 5, 2), (64, 100, 3), (1000, 50, 2)])
def test_core_rmq(core, rho, Q, distinct):
    values, table, lo, hi = rmq_case(rho, Q, rho + Q, distinct)
    out = np.zeros(lo.shape[0], np.int32)
    core.core_rmq(_p(values), _p(table), _p(lo), _p(hi), _p(out), lo.shape[0],
                  table.shape[0], rho)
    want = rmq_plain(*(torch.from_numpy(a) for a in (values, table, lo, hi)))
    np.testing.assert_array_equal(out, want.numpy())
