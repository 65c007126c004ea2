"""Port parity: collections, pattern workloads and suffix data.

The same seeds go through ``repro`` (JAX, CPU) and ``repro_torch`` (CPU
tensors); every array must be equal, dtype included."""

import dataclasses

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

from repro.core import suffix as jsuffix
from repro.data import collections as jcoll
from repro.errors import InvalidQueryError as JInvalid
from repro_torch.core import suffix as tsuffix
from repro_torch.data import collections as tcoll
from repro_torch.errors import InvalidQueryError as TInvalid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPECS = {
    "version": dict(family="version", n_base=3, n_variants=7, base_len=90,
                    mutation_rate=0.01, seed=5),
    "dna": dict(family="dna", n_base=1, n_variants=16, base_len=150,
                mutation_rate=0.003, seed=9),
    "concat": dict(family="concat", n_base=3, n_variants=4, base_len=40,
                   mutation_rate=0.05, seed=2),
}


def _colls(name):
    if name == "paperlike-dna-p001":
        return (jcoll.generate(jcoll.paperlike_collections(0.3)["dna-p001"]),
                tcoll.generate(tcoll.paperlike_collections(0.3)["dna-p001"]))
    if name == "one-doc":
        return (jsuffix.concat_documents(["abracadabra"]),
                tsuffix.concat_documents(["abracadabra"]))
    if name == "two-docs":
        docs = [np.array([0, 1, 0, 1, 2]), np.array([1, 0, 1, 2, 2, 0])]
        return jsuffix.concat_documents(docs), tsuffix.concat_documents(docs)
    return (jcoll.generate(jcoll.SyntheticSpec(**SPECS[name])),
            tcoll.generate(tcoll.SyntheticSpec(**SPECS[name])))


ALL = list(SPECS) + ["paperlike-dna-p001", "one-doc", "two-docs"]


def _same(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ALL)
def test_collections_equal(name):
    jc, tc = _colls(name)
    for f in ("text", "doc_starts", "doc_ends"):
        _same(getattr(jc, f), getattr(tc, f))
    assert (jc.d, jc.sigma, jc.n) == (tc.d, tc.sigma, tc.n)


def test_paperlike_specs_equal():
    for scale in (0.3, 1.0, 3.2):
        js = jcoll.paperlike_collections(scale)
        ts = tcoll.paperlike_collections(scale)
        assert list(js) == list(ts)
        for k in js:
            assert dataclasses.asdict(js[k]) == dataclasses.asdict(ts[k])


@pytest.mark.parametrize("name", ALL)
def test_suffix_data_equal(name):
    jc, tc = _colls(name)
    jd = jsuffix.build_suffix_data(jc)
    td = tsuffix.build_suffix_data(tc, device="cpu")
    for f in ("sa", "rank", "lcp", "da", "c", "ilcp"):
        _same(getattr(jd, f), getattr(td, f).numpy())


@pytest.mark.parametrize("name", ["version", "dna", "paperlike-dna-p001"])
def test_random_substring_patterns_equal(name):
    jc, tc = _colls(name)
    for kw in (dict(by_occ_df_ratio=True), dict(by_occ_df_ratio=False)):
        jp = jcoll.random_substring_patterns(jc, 300, 5, 24, **kw)
        tp = tcoll.random_substring_patterns(tc, 300, 5, 24, device="cpu", **kw)
        assert len(jp) == len(tp) > 0
        for a, b in zip(jp, tp):
            _same(a, b)


def test_sa_range_for_pattern_equal():
    jc, tc = _colls("dna")
    jd = jsuffix.build_suffix_data(jc)
    td = tsuffix.build_suffix_data(tc, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(20):
        m = int(rng.integers(1, 8))
        p = int(rng.integers(0, jc.n - m))
        pat = jc.text[p : p + m]
        assert jsuffix.sa_range_for_pattern(jd, pat) == tsuffix.sa_range_for_pattern(td, pat)


PATTERN_CASES = [
    [np.array([1, 2, 3]), np.array([], np.int32), "ac", b"\x00\x01",
     np.array([4, 4, 4, 4, 4, 4]), np.array([-1, 2]), np.array([9, 1]),
     np.arange(50, dtype=np.int64) % 4 + 1, [1, 2], (3,)],
    [np.zeros(0, np.int32)],
    [],
]


@pytest.mark.parametrize("case", range(len(PATTERN_CASES)))
@pytest.mark.parametrize("sigma,max_len", [(None, None), (5, 8), (300, 4)])
def test_normalize_and_pad_equal(case, sigma, max_len):
    pats = PATTERN_CASES[case]
    jn = jcoll.normalize_patterns(pats, sigma=sigma, max_len=max_len)
    tn = tcoll.normalize_patterns(pats, sigma=sigma, max_len=max_len)
    assert len(jn) == len(tn)
    for a, b in zip(jn, tn):
        _same(a, b)
    for max_m in (None, 3):
        jp, jl = jcoll.pad_patterns(jn, max_m)
        tp, tl = tcoll.pad_patterns(tn, max_m)
        _same(jp, tp)
        _same(jl, tl)


@pytest.mark.parametrize("bad", [[None], [1.5], [np.zeros((2, 2), np.int32)],
                                 [np.array([0.5, 1.0])], [object()]])
def test_normalize_rejects_the_same_input(bad):
    with pytest.raises(JInvalid):
        jcoll.normalize_patterns(bad)
    with pytest.raises(TInvalid):
        tcoll.normalize_patterns(bad)


def test_common_helpers_equal():
    from repro import common as jc
    from repro_torch import common as tc

    for x in range(0, 300):
        assert jc.ceil_log2(x) == tc.ceil_log2(x)
        for m in (0, 1, 7, 64):
            assert jc.elias_fano_bits(m, x + m) == tc.elias_fano_bits(m, x + m)
        if x >= 1:
            assert jc.floor_log2(x) == tc.floor_log2(x)
            assert jc.delta_code_len(x) == tc.delta_code_len(x)
            assert jc.gamma_code_len(x) == tc.gamma_code_len(x)
    xs = np.arange(1, 5000, dtype=np.int32)
    assert tc.floor_log2_t(tc.as_i32(xs)).tolist() == [jc.floor_log2(int(x)) for x in xs]
    assert tc.as_i32([1, 2]).dtype == tc.IDX
    with pytest.raises(ValueError):
        tc.delta_code_len(0)
