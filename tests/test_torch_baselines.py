"""The paper's baseline listers and the CSA helpers: the port against the
reference on the same seeded collections.

Brute-D (docs, count, freqs), Sada-C-D and Sada-C-L (RMQ recursion over
C), Sada-I-L (the ILCP recursion with DA located through the CSA), the WT
lister (docs, freqs, count) and ``wt_topk`` must give the reference's
integers row for row, in the reference's order (discovery order for
Sada-C and Sada-I), at ``max_df = d + 1`` (the paper's benchmark setting)
and at a truncating ``max_df``, on pattern ranges, seeded arbitrary
ranges, (0, n) and masked (0, 0) rows.  The reference's single-query
functions are vmapped over the batch, as its benchmarks run them.  The
port's wrappers run their kernels' plain versions here (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csa as jcsa
from repro.core import ilcp as jilcp
from repro.core import listing as jlisting
from repro.core import wtlist as jwt
from repro.core.suffix import build_suffix_data as jbuild_suffix_data
from repro.core.suffix import sa_range_for_pattern
from repro.data import collections as jcoll
from repro.succinct import rmq as jrmq
from repro_torch import convert
from repro_torch.core import csa as tcsa
from repro_torch.core import ilcp as tilcp
from repro_torch.core import listing as tlisting
from repro_torch.core import wtlist as twt
from repro_torch.core.suffix import Collection, build_suffix_data
from repro_torch.succinct import rmq as trmq
from repro_torch.succinct.wavelet import WaveletMatrix


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPECS = {
    "version": jcoll.SyntheticSpec("version", n_base=3, n_variants=7, base_len=90,
                                   mutation_rate=0.01, seed=5),
    "dna": jcoll.paperlike_collections(0.05)["dna-p001"],
}
#: the truncating row width
SHORT = 3


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _fields(v)
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


@pytest.fixture(scope="module", params=list(SPECS))
def idx(request):
    coll = jcoll.generate(SPECS[request.param])
    jdata = jbuild_suffix_data(coll)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tdata = build_suffix_data(tcoll, "cpu")
    ranges = [sa_range_for_pattern(jdata, p)
              for p in jcoll.random_substring_patterns(coll, 200, 1, 24, seed=4)]
    rng = np.random.default_rng(8)
    a = rng.integers(0, coll.n + 1, 16)
    b = rng.integers(0, coll.n + 1, 16)
    ranges += list(zip(np.minimum(a, b), np.maximum(a, b)))
    ranges += [(0, 0), (0, coll.n), (0, 0), (coll.n - 1, coll.n), (0, 1)]
    lo = np.asarray([r[0] for r in ranges], np.int32)
    hi = np.asarray([r[1] for r in ranges], np.int32)
    return dict(
        coll=coll, jdata=jdata, tdata=tdata, lo=lo, hi=hi, d=coll.d,
        jcsa=jcsa.build_csa(jdata), tcsa=tcsa.build_csa(tdata),
        jilcp=jilcp.build_ilcp(jdata), tilcp=tilcp.build_ilcp(tdata),
        jrmq=jrmq.rmq_build(jdata.c), trmq=trmq.rmq_build(tdata.c),
        jwm=jwt.build_da_wavelet(jdata.da, coll.d), twm=twt.build_da_wavelet(tdata.da, coll.d),
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want, what):
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        assert g.dtype == np.int32, what
        np.testing.assert_array_equal(g, w.view(np.int32), what)


def _vmap(fn, lo, hi):
    return jax.jit(jax.vmap(fn))(jnp.asarray(lo), jnp.asarray(hi))


def _oracle_rows(da, lo, hi):
    return [sorted(set(da[a:b].tolist())) for a, b in zip(lo, hi)]


def test_fixture_has_masked_and_full_rows(idx):
    lo, hi = idx["lo"], idx["hi"]
    assert ((lo == 0) & (hi == 0)).sum() == 2 and ((lo == 0) & (hi == idx["coll"].n)).any()


def test_index_structures_equal(idx):
    """C's RMQ and the DA wavelet matrix: the reference's arrays."""
    for j, t in ((idx["jrmq"], idx["trmq"]), (idx["jwm"], idx["twm"])):
        for f in dataclasses.fields(t):
            g, w = getattr(t, f.name), getattr(j, f.name)
            if isinstance(g, torch.Tensor):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int32), f.name)
            else:
                assert g == w, f.name
    assert trmq.rmq_modeled_bits_table(idx["trmq"]) == jrmq.rmq_modeled_bits_table(idx["jrmq"])
    n = idx["coll"].n
    assert trmq.rmq_modeled_bits_succinct(n) == jrmq.rmq_modeled_bits_succinct(n)
    assert twt.wt_modeled_bits(idx["twm"]) == jwt.wt_modeled_bits(idx["jwm"])
    assert tilcp.ilcp_num_runs(idx["tdata"]) == jilcp.ilcp_num_runs(idx["jdata"]) \
        == idx["tilcp"].nruns


@pytest.mark.parametrize("max_occ,max_df", [(64, None), (16, SHORT)])
def test_brute_d(idx, max_occ, max_df):
    lo, hi, d = idx["lo"], idx["hi"], idx["d"]
    max_df = max_df or d + 1
    want = jlisting.brute_list_da_batch(jnp.asarray(idx["jdata"].da), jnp.asarray(lo),
                                        jnp.asarray(hi), max_occ, max_df)
    got = tlisting.brute_list_da_batch(idx["tdata"].da, _t(lo), _t(hi), max_occ, max_df)
    _same(got, want, "brute_list_da_batch")
    one = tlisting.brute_list_da(idx["tdata"].da, int(lo[0]), int(hi[0]), max_occ, max_df)
    _same(one, [w[0] for w in want], "brute_list_da")


@pytest.mark.parametrize("source", ["da", "csa"])
@pytest.mark.parametrize("short", [False, True])
def test_sada_c(idx, source, short):
    """Sada-C-D and Sada-C-L rows in discovery order, and the oracle's
    documents wherever df fits."""
    lo, hi, d = idx["lo"], idx["hi"], idx["d"]
    max_df = SHORT if short else d + 1
    if source == "da":
        jda = jnp.asarray(idx["jdata"].da)
        want = _vmap(lambda a, b: jlisting.sada_c_list_docs_da(idx["jrmq"], jda, a, b, d,
                                                               max_df), lo, hi)
        got = tlisting.sada_c_list_docs_da_batch(idx["trmq"], idx["tdata"].da, _t(lo), _t(hi),
                                                 d, max_df)
    else:
        want = _vmap(lambda a, b: jlisting.sada_c_list_docs_csa(idx["jrmq"], idx["jcsa"], a, b,
                                                                max_df), lo, hi)
        got = tlisting.sada_c_list_docs_csa_batch(idx["trmq"], idx["tcsa"], _t(lo), _t(hi),
                                                  max_df)
    _same(got, want, f"sada_c[{source}]")
    docs, cnt = (g.numpy() for g in got)
    for r, truth in enumerate(_oracle_rows(idx["jdata"].da, lo, hi)):
        assert cnt[r] == min(len(truth), max_df)
        assert set(docs[r, : cnt[r]].tolist()) <= set(truth)


@pytest.mark.parametrize("short", [False, True])
def test_sada_i_l(idx, short):
    """Sada-I-L: the ILCP recursion with DA located through the CSA, in
    discovery order; equal to Sada-I-D's rows."""
    lo, hi, d = idx["lo"], idx["hi"], idx["d"]
    max_df = SHORT if short else d + 1
    want = _vmap(lambda a, b: jilcp.ilcp_list_docs_csa(idx["jilcp"], idx["jcsa"], a, b, max_df),
                 lo, hi)
    got = tilcp.ilcp_list_docs_csa_batch(idx["tilcp"], idx["tcsa"], _t(lo), _t(hi), max_df)
    _same(got, want, "ilcp_list_docs_csa_batch")
    stored = tilcp.ilcp_list_docs_da_planned(idx["tilcp"], idx["tdata"].da, _t(lo), _t(hi),
                                             max_df)
    _same(got, stored, "Sada-I-L against Sada-I-D")


def test_single_range_forms(idx):
    """The single-range forms: their batch functions over a batch of one."""
    d, max_df = idx["d"], idx["d"] + 1
    r = 3
    lo, hi = int(idx["lo"][r]), int(idx["hi"][r])
    jda = jnp.asarray(idx["jdata"].da)
    cases = [
        (tilcp.ilcp_list_docs(idx["tilcp"], idx["tcsa"], lo, hi, max_df),
         jilcp.ilcp_list_docs_csa(idx["jilcp"], idx["jcsa"], lo, hi, max_df)),
        (tilcp.ilcp_list_docs(idx["tilcp"], idx["tdata"].da, lo, hi, max_df),
         jilcp.ilcp_list_docs_da(idx["jilcp"], jda, lo, hi, max_df)),
        (tlisting.sada_c_list_docs_da(idx["trmq"], idx["tdata"].da, lo, hi, d, max_df),
         jlisting.sada_c_list_docs_da(idx["jrmq"], jda, lo, hi, d, max_df)),
        (tlisting.sada_c_list_docs_csa(idx["trmq"], idx["tcsa"], lo, hi, max_df),
         jlisting.sada_c_list_docs_csa(idx["jrmq"], idx["jcsa"], lo, hi, max_df)),
        (twt.wt_list_docs(idx["twm"], lo, hi, max_df),
         jwt.wt_list_docs(idx["jwm"], lo, hi, max_df)),
        (twt.wt_topk(idx["twm"], lo, hi, 4, max_df), jwt.wt_topk(idx["jwm"], lo, hi, 4, max_df)),
    ]
    for i, (got, want) in enumerate(cases):
        _same(got, want, f"case {i}")


@pytest.mark.parametrize("short", [False, True])
def test_wt_list(idx, short):
    """WT docs ascending, freqs and count; the oracle's (doc, tf) pairs
    wherever df fits."""
    lo, hi, d = idx["lo"], idx["hi"], idx["d"]
    max_df = SHORT if short else d + 1
    want = _vmap(lambda a, b: jwt.wt_list_docs(idx["jwm"], a, b, max_df), lo, hi)
    got = twt.wt_list_docs_batch(idx["twm"], _t(lo), _t(hi), max_df)
    _same(got, want, "wt_list_docs")
    docs, freqs, cnt = (g.numpy() for g in got)
    da = idx["jdata"].da
    for r in range(len(lo)):
        vals, tf = np.unique(da[lo[r]:hi[r]], return_counts=True)
        c = min(len(vals), max_df)
        assert cnt[r] == c
        np.testing.assert_array_equal(docs[r, :c], vals[:c])
        np.testing.assert_array_equal(freqs[r, :c], tf[:c])


@pytest.mark.parametrize("k", [1, 4])
def test_wt_topk(idx, k):
    lo, hi, d = idx["lo"], idx["hi"], idx["d"]
    want = _vmap(lambda a, b: jwt.wt_topk(idx["jwm"], a, b, k, d + 1), lo, hi)
    got = twt.wt_topk_batch(idx["twm"], _t(lo), _t(hi), k, d + 1)
    _same(got, want, "wt_topk")


def test_csa_helpers(idx):
    """csa_search (single), csa_lookup_batch, csa_da_at and
    csa_locate_range: the reference's integers, and SA / DA themselves."""
    j, t, coll = idx["jcsa"], idx["tcsa"], idx["coll"]
    n = coll.n
    sa, da = np.asarray(idx["jdata"].sa), np.asarray(idx["jdata"].da)
    rng = np.random.default_rng(3)
    pos = np.concatenate([[0, n - 1], rng.integers(0, n, 64)]).astype(np.int32)
    got = tcsa.csa_lookup_batch(t, _t(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcsa.csa_lookup_batch(j, pos)))
    np.testing.assert_array_equal(got.numpy(), sa[pos])
    got = tcsa.csa_da_at(t, _t(pos))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.vmap(lambda i: jcsa.csa_da_at(j, i))(pos)))
    np.testing.assert_array_equal(got.numpy(), da[pos])
    for lo in (0, 5, n - 3):
        got = tcsa.csa_locate_range(t, lo, 8)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jcsa.csa_locate_range(j, lo, 8)))
    for p in jcoll.random_substring_patterns(coll, 100, 3, 6, seed=2) + [np.zeros(0, np.int32)]:
        padded = np.zeros(8, np.int32)
        padded[: len(p)] = p
        got = tcsa.csa_search(t, _t(padded), len(p))
        want = jcsa.csa_search(j, jnp.asarray(padded), len(p))
        assert [int(x) for x in got] == [int(x) for x in want]
        assert all(x.dtype == torch.int32 and x.dim() == 0 for x in got)


def test_carried_across(idx):
    """C's RMQ and the DA wavelet matrix carried from the reference by
    ``convert.from_numpy`` list as the port's own."""
    rmq_c = convert.from_numpy(trmq.SparseTableRMQ, _fields(idx["jrmq"]), "cpu")
    wm = convert.from_numpy(WaveletMatrix, _fields(idx["jwm"]), "cpu")
    lo, hi, d = _t(idx["lo"]), _t(idx["hi"]), idx["d"]
    _same(tlisting.sada_c_list_docs_da_batch(rmq_c, idx["tdata"].da, lo, hi, d, d + 1),
          tlisting.sada_c_list_docs_da_batch(idx["trmq"], idx["tdata"].da, lo, hi, d, d + 1),
          "sada_c over the carried RMQ")
    _same(twt.wt_list_docs_batch(wm, lo, hi, d + 1),
          twt.wt_list_docs_batch(idx["twm"], lo, hi, d + 1), "wt over the carried matrix")
