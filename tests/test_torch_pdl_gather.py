"""The PDL gather three ways: the CUDA kernel's core built for the host,
the port's plain version and the reference's ``_pdl_gather``.

``rt::pdl_gather_one`` and ``rt::csa_locate_one`` of
``repro_torch/csrc/retrieval_core.cuh`` are built with g++ behind a C shim
(``test_torch_kernel_core.compile_core``).  On two small seeded
collections, with both PDLs (listing and top-k), the core, the port's
``pdl_gather_plain`` and ``repro.core.pdl._pdl_gather`` (vmapped over the
batch) must give the same integers, buffer, frequencies and count, for
empty ranges, ranges inside one block, whole-collection ranges, a
``max_buf`` that truncates in the windows and in the expansion, and
``max_cover`` 1.  The locate core is held to the reference's
``csa_lookup_batch`` and the suffix array itself.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csa as jcsa
from repro.core import pdl as jpdl
from repro.core.suffix import build_suffix_data as jbuild_suffix_data
from repro.core.suffix import sa_range_for_pattern
from repro.data import collections as jcoll
from repro_torch.core.csa import build_csa
from repro_torch.core.pdl import build_pdl
from repro_torch.core.suffix import Collection, build_suffix_data
from repro_torch.kernels.pdl_gather import kernel_operands, pdl_gather, pdl_gather_plain
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

static rt::PdlView pdl_view(const void* const* p, const int* v) {
  return rt::PdlView{
      (const int32_t*)p[8], (const uint8_t*)p[9], (const int32_t*)p[10],
      (const int32_t*)p[11], (const int32_t*)p[12], (const int32_t*)p[13],
      (const int32_t*)p[14], (const int32_t*)p[15], (const int32_t*)p[16],
      (const int32_t*)p[17], (const int32_t*)p[18],
      v[7], v[8], v[9], v[10], v[11], v[12], v[13], v[14], v[15], v[16]};
}

extern "C" void core_csa_locate(const void* const* p, const int* v,
                                const int32_t* idx, int32_t* sa,
                                int32_t* doc, int Q) {
  const rt::CsaView c = csa_view(p, v);
  for (int q = 0; q < Q; ++q) {
    sa[q] = rt::csa_locate_one(c, idx[q]);
    doc[q] = rt::csa_doc_of(c, sa[q]);
  }
}

extern "C" void core_pdl_gather(const void* const* p, const int* v,
                                const int32_t* lo, const int32_t* hi,
                                int32_t* buf, int32_t* fbuf, int32_t* count,
                                int B, int max_buf, int max_cover) {
  const rt::CsaView c = csa_view(p, v);
  const rt::PdlView pd = pdl_view(p, v);
  std::vector<int32_t> stack(pd.stack_size);
  for (int q = 0; q < B; ++q)
    count[q] = rt::pdl_gather_one(c, pd, lo[q], hi[q], max_buf, max_cover,
                                  buf + (long)q * max_buf,
                                  fbuf + (long)q * max_buf, stack.data());
}
"""

SPECS = {
    "version": jcoll.SyntheticSpec("version", n_base=3, n_variants=7, base_len=90,
                                   mutation_rate=0.01, seed=5),
    "dna": jcoll.paperlike_collections(0.05)["dna-p001"],
}
BLOCK = 8
BETA = 4.0
#: (max_buf, max_cover): no truncation; a buffer the windows and the
#: expansion overrun; one cover step
CONFIGS = {"full": (1024, 1024), "max_buf": (3, 1024), "cover1": (1024, 1)}


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return compile_core(SHIM, tmp_path_factory.mktemp("pdl_core"))


def _p(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


class _Operands:
    """The index operands as numpy arrays, with the pointer and size
    arrays the shim reads (kept alive with the arrays)."""

    def __init__(self, pdl, csa):
        tensors, ints = kernel_operands(pdl, csa)
        self.arrays = [np.ascontiguousarray(t.numpy()) for _, t, _ in tensors]
        self.ptrs = (ctypes.c_void_p * len(self.arrays))(
            *(a.ctypes.data for a in self.arrays))
        self.ints = (ctypes.c_int * len(ints))(*ints)


@pytest.fixture(scope="module", params=list(SPECS))
def indexes(request):
    coll = jcoll.generate(SPECS[request.param])
    jdata = jbuild_suffix_data(coll)
    jc = jcsa.build_csa(jdata)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tdata = build_suffix_data(tcoll, "cpu")
    tc = build_csa(tdata)
    modes = {}
    for mode, beta in (("list", BETA), ("topk", None)):
        jp = jpdl.build_pdl(jdata, block_size=BLOCK, beta=beta, mode=mode)
        tp = build_pdl(tdata, block_size=BLOCK, beta=beta, mode=mode)
        modes[mode] = (jp, tp, _Operands(tp, tc))
    # ranges: pattern ranges of every length class, then edge ranges
    ranges = [sa_range_for_pattern(jdata, p)
              for p in jcoll.random_substring_patterns(coll, 400, 3, 40, seed=3)]
    n = coll.n
    ranges += [(0, 0), (5, 5), (9, 3), (1, 2), (3, BLOCK - 1), (BLOCK + 1, 2 * BLOCK - 2),
               (0, n), (n - 1, n), (1, n - 1), (0, BLOCK), (n - BLOCK, n)]
    lo = np.asarray([r[0] for r in ranges], np.int32)
    hi = np.asarray([r[1] for r in ranges], np.int32)
    return {"jcsa": jc, "tcsa": tc, "modes": modes, "lo": lo, "hi": hi, "n": n,
            "sa": np.asarray(jdata.sa), "da": np.asarray(jdata.da)}


def test_core_csa_locate(core, indexes):
    """SA and DA of every position by the kernel's locate core, against the
    reference's ``csa_lookup_batch`` and the suffix data itself."""
    ops = indexes["modes"]["list"][2]
    n = indexes["n"]
    idx = np.arange(n, dtype=np.int32)
    sa = np.zeros(n, np.int32)
    doc = np.zeros(n, np.int32)
    core.core_csa_locate(ops.ptrs, ops.ints, _p(idx), _p(sa), _p(doc), n)
    want = np.asarray(jax.jit(jcsa.csa_lookup_batch, static_argnums=())(
        indexes["jcsa"], jnp.asarray(idx)))
    np.testing.assert_array_equal(sa, want)
    np.testing.assert_array_equal(sa, indexes["sa"])
    np.testing.assert_array_equal(doc, indexes["da"])


def _reference_gather(jp, jc, lo, hi, max_buf, max_cover):
    fn = jax.jit(jax.vmap(lambda a, b: jpdl._pdl_gather(jp, jc, a, b, max_buf, max_cover)))
    return [np.asarray(x) for x in fn(jnp.asarray(lo), jnp.asarray(hi))]


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mode", ["list", "topk"])
def test_pdl_gather_three_ways(core, indexes, mode, config):
    max_buf, max_cover = CONFIGS[config]
    jp, tp, ops = indexes["modes"][mode]
    lo, hi = indexes["lo"], indexes["hi"]
    B = lo.shape[0]
    buf = np.full((B, max_buf), -7, np.int32)
    fbuf = np.full((B, max_buf), -7, np.int32)
    count = np.zeros(B, np.int32)
    core.core_pdl_gather(ops.ptrs, ops.ints, _p(lo), _p(hi), _p(buf), _p(fbuf), _p(count),
                         B, max_buf, max_cover)
    plain = [x.numpy() for x in pdl_gather_plain(
        tp, indexes["tcsa"], torch.from_numpy(lo), torch.from_numpy(hi), max_buf, max_cover)]
    ref = _reference_gather(jp, indexes["jcsa"], lo, hi, max_buf, max_cover)
    for name, got, p, r in zip(("docs", "tf", "count"), (buf, fbuf, count), plain, ref):
        np.testing.assert_array_equal(p, r, err_msg=f"plain {name} != reference")
        np.testing.assert_array_equal(got, r, err_msg=f"core {name} != reference")
    # the cases the run must show: truncation where asked for, both kinds of
    # work, and empty rows
    assert (count == 0).any()
    if config == "max_buf":  # windows past the buffer; expansion stopped at it
        assert (count > max_buf).any() and (count == max_buf).any()
    if config == "full":
        assert (count > 2 * BLOCK).any() and (count <= max_buf).all()


def test_pdl_gather_wrapper_cpu(indexes):
    """On CPU tensors the wrapper is the plain version; an empty batch is
    the closed-form empty answer, and negative sizes are refused."""
    _, tp, _ = indexes["modes"]["topk"]
    lo, hi = torch.from_numpy(indexes["lo"]), torch.from_numpy(indexes["hi"])
    got = pdl_gather(tp, indexes["tcsa"], lo, hi, 64, 1024)
    want = pdl_gather_plain(tp, indexes["tcsa"], lo, hi, 64, 1024)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    docs, tf, count = pdl_gather(tp, indexes["tcsa"], lo[:0], hi[:0], 64, 1024)
    assert docs.shape == tf.shape == (0, 64) and count.shape == (0,)
    with pytest.raises(ValueError):
        pdl_gather(tp, indexes["tcsa"], lo, hi, -1, 1024)
