"""The embedding-bag kernel's lane-group core, compiled for the host.

``repro_torch/csrc/embedding_bag_core.cuh`` holds the kernel's logic as
``__host__ __device__`` functions: the plan (vector bytes W, lanes a bag G,
rows in flight a lane U) and the per-lane phases of both kernel loops
(bags of one; longer bags).  Here g++ builds it behind a small C shim that
runs the kernel's loops with one thread playing each of a warp's 32
lanes in turn: every lane's index loads first, then every lane's rows,
each shuffle reading the source lane's loaded register.  The shim takes
real table and output addresses, so the plan sees the base pointers'
alignment.  Its outputs are held to ``embedding_bag_plain`` bit for bit
(the kernel adds in the plain version's order and rounds once) and, in
f32 at D = 10, to the reference's ``embedding_bag_ref`` within 1e-6.  The CUDA
kernel itself runs only on the card (``chip_smoke.py``, phase 6).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels.embedding_bag import embedding_bag_plain


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
#include "embedding_bag_core.cuh"

namespace {

// Every lane's index registers, read by a shuffle's source lane.
template <int U>
struct HostShfl {
  const int32_t (*regs)[U];
  int32_t operator()(int32_t, int reg, int src) const { return regs[src][reg]; }
};

// embedding_bag_kernel's loops for one warp item at a time, last item
// first (warps run in no set order), one thread playing the 32 lanes phase
// by phase (the kernel loads an item's first indices one item ahead; the
// values are the same).
template <class T, int W>
int run(const eb::Plan& p, const uint8_t* table, const int32_t* idx, uint8_t* out,
        long long B, int L, int mean) {
  constexpr int E = eb::elems<T, W>(), U = eb::kU;
  const long long items = eb::warp_items(p, B, L);
  int32_t regs[eb::kWarp][U];
  const HostShfl<U> shfl{regs};
  for (long long w = items - 1; w >= 0; --w) {
    if (L == 1) {
      const long long base = w * p.tile;
      for (int lane = 0; lane < eb::kWarp; ++lane)
        eb::bag1_load_indices<U>(p, idx, B, base, lane, regs[lane]);
      for (int lane = 0; lane < eb::kWarp; ++lane)
        eb::bag1_tile<T, W, U>(p, table, out, B, base, mean, lane, regs[lane], shfl);
      continue;
    }
    for (int c = 0; c < p.chunks; ++c) {
      float acc[eb::kWarp][E];
      int count[eb::kWarp];
      for (int lane = 0; lane < eb::kWarp; ++lane) {
        for (int e = 0; e < E; ++e) acc[lane][e] = 0.f;
        count[lane] = 0;
      }
      for (int t0 = 0; t0 < L; t0 += p.chunk) {
        for (int lane = 0; lane < eb::kWarp; ++lane) {
          const long long bag = w * p.bpw + (lane >> p.lg);
          eb::rows_load_indices<U>(p, idx, L, bag, bag < B, t0, lane, regs[lane]);
        }
        for (int lane = 0; lane < eb::kWarp; ++lane) {
          const long long bag = w * p.bpw + (lane >> p.lg);
          const int col = c * p.G + (lane & (p.G - 1));
          eb::rows_chunk<T, W, U>(p, table, col, bag < B && col < p.nvec, lane, regs[lane],
                                  acc[lane], count[lane], shfl);
        }
      }
      for (int lane = 0; lane < eb::kWarp; ++lane) {
        const long long bag = w * p.bpw + (lane >> p.lg);
        const int col = c * p.G + (lane & (p.G - 1));
        if (bag < B && col < p.nvec)
          eb::finish<T, W>(out + bag * p.R + (long long)col * W, acc[lane], count[lane], mean);
      }
    }
  }
  return 0;
}

template <class T>
int dispatch(const void* table, const int32_t* idx, void* out, long long B, int L, int D,
             int mean) {
  const eb::Plan p = eb::make_plan(D, T::kBytes, (uintptr_t)table, (uintptr_t)out);
  return eb::with_plan<T>(p, [&](auto w) {
    return run<T, decltype(w)::value>(p, (const uint8_t*)table, idx, (uint8_t*)out, B, L, mean);
  });
}

}  // namespace

extern "C" void core_eb_plan(int D, int esize, unsigned long long table,
                             unsigned long long out, int* res) {
  const eb::Plan p = eb::make_plan(D, esize, (uintptr_t)table, (uintptr_t)out);
  res[0] = p.W, res[1] = p.G, res[2] = p.U, res[3] = p.chunks;
}

extern "C" int core_embedding_bag(const void* table, const int32_t* idx, void* out,
                                  long long B, int L, int D, int is_bf16, int mean) {
  return is_bf16 ? dispatch<eb::BF16>(table, idx, out, B, L, D, mean)
                 : dispatch<eb::F32>(table, idx, out, B, L, D, mean);
}
"""

DIMS = (1, 10, 16, 50, 128, 200)
ESIZE = {"f32": 4, "bf16": 2}
TDTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}

#: (W, G, U) at 16-byte-aligned bases, for each D: bf16 DLRM
#: (D 128, 256-B rows) 2 bags a warp, AutoInt (16, 32 B) 16, FM (10) 4 and
#: FM (1) 32
ALIGNED_PLANS = {
    "bf16": {1: (2, 1, 4), 10: (4, 8, 4), 16: (16, 2, 4), 50: (4, 32, 4),
             128: (16, 16, 4), 200: (16, 32, 4)},
    "f32": {1: (4, 1, 4), 10: (8, 8, 4), 16: (16, 4, 4), 50: (8, 32, 4),
            128: (16, 32, 4), 200: (16, 32, 4)},
}


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel core")
    out = tmp_path_factory.mktemp("eb_core")
    src = out / "shim.cpp"
    src.write_text(SHIM)
    lib = out / "libebcore.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(lib),
         str(src)],
        check=True, capture_output=True, text=True,
    )
    cdll = ctypes.CDLL(str(lib))
    cdll.core_eb_plan.argtypes = [ctypes.c_int] * 2 + [ctypes.c_ulonglong] * 2 + [
        ctypes.c_void_p]
    cdll.core_embedding_bag.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
        ctypes.c_int] * 4
    cdll.core_embedding_bag.restype = ctypes.c_int
    return cdll


def plan_of(core, D, esize, table_addr, out_addr):
    res = np.zeros(4, np.int32)
    core.core_eb_plan(D, esize, table_addr, out_addr, res.ctypes.data)
    return tuple(int(x) for x in res)


def expected_plan(D, esize, table_addr, out_addr):
    """The plan's rule restated: the widest of 16, 8, 4, 2 bytes (at least
    one element) dividing the row and both bases; G the next power of two
    of the row's vectors, at most 32; U = 4; the column chunks."""
    R = D * esize
    W = next((w for w in (16, 8, 4, 2)
              if w >= esize and R % w == 0 and table_addr % w == 0 and out_addr % w == 0), esize)
    G = min(32, 1 << max(R // W - 1, 0).bit_length())
    return W, G, 4, -(-(R // W) // G)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("offsets", [(0, 0), (2, 0), (0, 2), (4, 4), (8, 0), (0, 8)])
def test_plan(core, dtype, D, offsets):
    esize = ESIZE[dtype]
    if esize == 4 and 2 in offsets:
        offsets = tuple(4 if o == 2 else o for o in offsets)  # f32 bases are 4-byte aligned
    table_addr, out_addr = (1 << 20) + offsets[0], (3 << 20) + offsets[1]
    got = plan_of(core, D, esize, table_addr, out_addr)
    assert got == expected_plan(D, esize, table_addr, out_addr)
    if offsets == (0, 0):
        assert got[:3] == ALIGNED_PLANS[dtype][D]
    if esize == 2 and 2 in offsets:
        assert got[0] == 2  # a 2-byte-offset base takes one bf16 a lane


def _buffer(nbytes, misalign):
    """A zeroed uint8 view of ``nbytes`` whose address is ``misalign`` past
    a 16-byte boundary (and its owner)."""
    raw = np.zeros(nbytes + 64, np.uint8)
    start = (-raw.ctypes.data) % 16 + misalign
    return raw[start:start + nbytes]


def _bags(rng, V, B, L):
    """int32 [B, L]: rows in [0, V) with repeats, padding (-1 and other
    negatives) at the end and inside bags, and whole bags of padding."""
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    if L > 1:
        idx[:, rng.integers(0, L)] = idx[:, 0]  # repeated rows
        lens = rng.integers(0, L + 1, B)
        idx[np.arange(L)[None, :] >= lens[:, None]] = -1
        idx[rng.random((B, L)) < 0.1] = -7
    else:
        idx[rng.random((B, L)) < 0.1] = -1
        idx[3::11, 0] = idx[3, 0]  # repeated rows
    idx[::7] = -1  # empty bags
    return np.ascontiguousarray(idx)


def run_core(core, table_t, idx, mode, misalign=(0, 0)):
    """The emulated kernel on a CPU table tensor and int32 bags."""
    V, D = table_t.shape
    B = idx.shape[0]
    esize = table_t.element_size()
    tbuf = _buffer(V * D * esize, misalign[0])
    tbuf[:] = table_t.contiguous().view(torch.uint8).reshape(-1).numpy()
    obuf = _buffer(B * D * esize, misalign[1])
    rc = core.core_embedding_bag(tbuf.ctypes.data, idx.ctypes.data, obuf.ctypes.data, B,
                                 idx.shape[1], D, int(esize == 2), int(mode == "mean"))
    assert rc == 0
    return obuf.view(np.int16 if esize == 2 else np.int32).reshape(B, D).copy()


def _table(rng, V, D, dtype):
    return torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)).to(TDTYPE[dtype])


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("L", [1, 5, 32])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_core_matches_plain_bit_for_bit(core, dtype, D, L, mode):
    rng = np.random.default_rng(D * 100 + L)
    V = 97
    B = 300 if L == 1 else 37  # more than one warp tile at D = 1 (256 bags)
    table = _table(rng, V, D, dtype)
    idx = _bags(rng, V, B, L)
    want = embedding_bag_plain(table, torch.from_numpy(idx), mode=mode)
    for misalign in ((0, 0), (ESIZE[dtype], 0), (0, ESIZE[dtype])):
        got = run_core(core, table, idx, mode, misalign)
        np.testing.assert_array_equal(got, _bits(want), err_msg=str(misalign))
    if dtype == "f32" and D == 10:  # the reference once per L and mode (compiles are slow)
        valid = idx >= 0
        offsets = np.concatenate([[0], np.cumsum(valid.sum(1))]).astype(np.int32)
        jref = ref.embedding_bag_ref(jnp.asarray(table.numpy()), jnp.asarray(idx[valid]),
                                     jnp.asarray(offsets), mode)
        np.testing.assert_allclose(got.view(np.float32), np.asarray(jref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [1, 10, 16, 50, 128])
def test_bags_of_one_return_the_row(core, dtype, D):
    """The recsys lookup: bags of one give each row back bit for bit."""
    rng = np.random.default_rng(D)
    table = _table(rng, 1000, D, dtype)
    ids = rng.integers(0, 1000, (777, 1)).astype(np.int32)
    got = run_core(core, table, ids, "sum")
    np.testing.assert_array_equal(got, _bits(table[torch.from_numpy(ids[:, 0]).long()]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_no_index_columns_give_zeros(core, dtype, mode):
    """L = 0: every bag is empty, every output element +0.0."""
    table = _table(np.random.default_rng(0), 20, 10, dtype)
    idx = np.zeros((9, 0), np.int32)
    got = run_core(core, table, idx, mode)
    np.testing.assert_array_equal(got, np.zeros((9, 10), got.dtype))
