"""The RLE bitvector, Sadakane's five counting encodings (Section 6.4.1)
and the skewed wavelet tree: the port against the reference.

``RLEBitvector`` rank/select/get on random, run-heavy, empty, all-zero and
all-one bit patterns, queries in and out of range; every Sada variant's
arrays, modeled size and counts on every suffix-tree node and on pattern
loci (where all five agree with the ILCP count and the oracle);
``hprime_runs_of_ones``; ``SkewedWaveletTree.count_less`` against the
port's ``wm_count_less`` and the reference's tree; and the validation of
RLE bitvectors and filter variants, mutation by mutation with the
reference's message, and Sada's fingerprint for every variant.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import replace as jreplace
from repro.core import ilcp as jilcp
from repro.core import sada as jsada
from repro.core.suffix import build_suffix_data as jbuild_suffix_data
from repro.core.suffix import sa_range_for_pattern
from repro.core.sufftree import lcp_interval_tree
from repro.data import collections as jcoll
from repro.errors import IndexIntegrityError as JIntegrity
from repro.serve import validate as jval
from repro.succinct import bitvector as jbv
from repro_torch import convert
from repro_torch.core import ilcp as tilcp
from repro_torch.core import sada as tsada
from repro_torch.core.suffix import Collection, build_suffix_data
from repro_torch.errors import IndexIntegrityError as TIntegrity
from repro_torch.serve import validate as tval
from repro_torch.succinct import bitvector as tbv
from repro_torch.succinct.wavelet import wm_count_less


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


def _bits(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 2, n).astype(np.uint8)
    if kind == "runs":  # few long runs, as a repetitive H' has
        lens = rng.geometric(0.05, n)
        return (np.repeat(np.arange(len(lens)) % 2, lens)[:n]).astype(np.uint8)
    return np.full(n, {"zeros": 0, "ones": 1}[kind], np.uint8)


RLE_CASES = [("random", 1), ("random", 300), ("runs", 1000), ("runs", 64), ("zeros", 50),
             ("ones", 50), ("ones", 1), ("empty", 0)]


@pytest.mark.parametrize("kind,n", RLE_CASES)
def test_rle_bitvector(kind, n):
    bits = _bits("zeros" if kind == "empty" else kind, n, n)
    want = jbv.rle_from_bits(bits)
    got = tbv.rle_from_bits(torch.from_numpy(bits))
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, torch.Tensor):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), f.name)
        else:
            assert g == w, f.name
    assert got.modeled_bits() == want.modeled_bits()
    m = int(bits.sum())
    ii = np.arange(-2, n + 3, dtype=np.int32)
    jj = np.arange(-2, max(m, n - m) + 3, dtype=np.int32)
    for name, q in (("rank1", ii), ("rank0", ii), ("get", np.clip(ii, 0, max(n - 1, 0))),
                    ("select1", jj), ("select0", jj)):
        if n == 0 and name == "select0":
            # the reference's gather over its zero-length zeros prefix
            # raises; the port answers n for every j, the out-of-range value
            assert (got.select0(torch.from_numpy(q)).numpy() == 0).all()
            continue
        w = np.asarray(getattr(want, name)(jnp.asarray(q)))
        g = getattr(got, name)(torch.from_numpy(q))
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, name)
    if n:  # the decoded bits, ranks and selects are the pattern's own
        np.testing.assert_array_equal(got.get(torch.arange(n, dtype=torch.int32)).numpy(), bits)
        np.testing.assert_array_equal(got.rank1(torch.from_numpy(ii[2:-2])).numpy(),
                                      np.concatenate([[0], np.cumsum(bits)]))
        np.testing.assert_array_equal(got.select1(torch.arange(m, dtype=torch.int32)).numpy(),
                                      np.flatnonzero(bits))


@pytest.fixture(scope="module", params=list(SPECS))
def data(request):
    coll = jcoll.generate(SPECS[request.param])
    jdata = jbuild_suffix_data(coll)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tdata = build_suffix_data(tcoll, "cpu")
    tree = lcp_interval_tree(jdata.lcp)
    pats = jcoll.random_substring_patterns(coll, 200, 1, 30, seed=4)
    loci = [sa_range_for_pattern(jdata, p) for p in pats]
    return dict(coll=coll, jdata=jdata, tdata=tdata,
                node_lo=tree.lo.astype(np.int32), node_hi=tree.hi.astype(np.int32),
                pat_len=np.asarray([len(p) for p in pats], np.int32),
                pat_lo=np.asarray([r[0] for r in loci], np.int32),
                pat_hi=np.asarray([r[1] for r in loci], np.int32))


def _same_structure(got, want, path):
    assert type(got).__name__ == type(want).__name__, path
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            _same_structure(g, w, f"{path}.{f.name}")
        elif isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int32),
                                          f"{path}.{f.name}")
        else:
            assert g == w, f"{path}.{f.name}"


def _counts(s, lo, hi):
    got = tsada.sada_count_batch(s, torch.from_numpy(lo), torch.from_numpy(hi))
    assert got.dtype == torch.int32
    return got.numpy()


@pytest.mark.parametrize("variant", jsada.VARIANTS)
def test_variant_matches_reference(data, variant):
    """Arrays (hp, fs, f1), modeled bits, and counts on every suffix-tree
    node (the structure's contract: the distinct documents) and on seeded
    arbitrary ranges (the same formula on both sides)."""
    want = jsada.build_sada(data["jdata"], variant)
    got = tsada.build_sada(data["tdata"], variant)
    _same_structure(got, want, variant)
    assert got.modeled_bits() == want.modeled_bits()
    lo, hi = data["node_lo"], data["node_hi"]
    counts = _counts(got, lo, hi)
    np.testing.assert_array_equal(
        counts, np.asarray(jsada.sada_count_batch(want, jnp.asarray(lo), jnp.asarray(hi))))
    da = data["jdata"].da
    np.testing.assert_array_equal(counts, [len(set(da[a:b].tolist())) for a, b in zip(lo, hi)])
    rng = np.random.default_rng(9)
    n = data["coll"].n
    a, b = rng.integers(0, n + 1, 200), rng.integers(0, n + 1, 200)
    lo = np.concatenate([np.minimum(a, b), [0, 0, n, 7]]).astype(np.int32)
    hi = np.concatenate([np.maximum(a, b), [0, n, n, 3]]).astype(np.int32)
    np.testing.assert_array_equal(
        _counts(got, lo, hi),
        np.asarray(jsada.sada_count_batch(want, jnp.asarray(lo), jnp.asarray(hi))))
    one = tsada.sada_count(got, int(lo[0]), int(hi[0]))
    assert one.dim() == 0 and int(one) == int(jsada.sada_count(want, int(lo[0]), int(hi[0])))


def test_variants_agree_on_pattern_loci(data):
    """On pattern loci all five variants, the ILCP count and the oracle give
    one df."""
    lo, hi, m = data["pat_lo"], data["pat_hi"], data["pat_len"]
    da = data["jdata"].da
    truth = np.asarray([len(set(da[a:b].tolist())) for a, b in zip(lo, hi)])
    ilcp = tilcp.ilcp_count_docs_batch(tilcp.build_ilcp(data["tdata"]), torch.from_numpy(lo),
                                       torch.from_numpy(hi), torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(ilcp, truth)
    for v in tsada.VARIANTS:
        np.testing.assert_array_equal(_counts(tsada.build_sada(data["tdata"], v), lo, hi),
                                      truth, v)


def test_modeled_sizes_and_runs(data):
    sizes = {v: tsada.build_sada(data["tdata"], v).modeled_bits() for v in tsada.VARIANTS}
    assert sizes == {v: jsada.build_sada(data["jdata"], v).modeled_bits()
                     for v in jsada.VARIANTS}
    assert tsada.hprime_runs_of_ones(data["tdata"]) == jsada.hprime_runs_of_ones(data["jdata"])


def test_hprime_runs_of_ones_of_trivial_collections():
    from repro.core.suffix import concat_documents
    from repro_torch.core.suffix import concat_documents as tconcat

    for docs in (["a"], ["ab", "ab"], ["abcabc"] * 5, ["TATA", "LATA", "AAAA"]):
        jdata = jbuild_suffix_data(concat_documents(docs))
        tdata = build_suffix_data(tconcat(docs), "cpu")
        assert tsada.hprime_runs_of_ones(tdata) == jsada.hprime_runs_of_ones(jdata), docs


def test_unknown_variant_refused(data):
    with pytest.raises(ValueError):
        tsada.build_sada(data["tdata"], "sparse_rle")


@pytest.mark.parametrize("variant", jsada.VARIANTS)
def test_variant_carried_across(data, variant):
    """``convert.from_numpy`` rebuilds each reference variant with its
    bitvector types, and counts as the reference."""
    want = jsada.build_sada(data["jdata"], variant)
    fields = {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}
    for key in ("hp", "fs", "f1"):
        bv = fields[key]
        fields[key] = {f.name: (np.asarray(getattr(bv, f.name))
                                if hasattr(getattr(bv, f.name), "shape") else getattr(bv, f.name))
                       for f in dataclasses.fields(bv)}
    got = convert.from_numpy(tsada.SadaCount, fields, "cpu")
    _same_structure(got, want, variant)
    lo, hi = data["node_lo"], data["node_hi"]
    np.testing.assert_array_equal(
        _counts(got, lo, hi),
        np.asarray(jsada.sada_count_batch(want, jnp.asarray(lo), jnp.asarray(hi))))


@pytest.mark.parametrize("m", [0, 1, 2, 3, 5, 9, 40])
def test_skewed_wavelet_tree(data, m):
    """count_less over the run heads, against the reference's tree and the
    port's wm_count_less on the ILCP index's wavelet matrix."""
    t = tilcp.build_ilcp(data["tdata"])
    vilcp = t.vilcp.numpy()
    got_tree = tilcp.SkewedWaveletTree(t.vilcp, t.max_value)
    want_tree = jilcp.SkewedWaveletTree(vilcp, t.max_value)
    assert got_tree.modeled_bits() == want_tree.modeled_bits()
    rho = t.nruns
    rng = np.random.default_rng(m)
    a, b = rng.integers(0, rho + 1, 40), rng.integers(0, rho + 1, 40)
    lo = np.concatenate([np.minimum(a, b), [0, 0, rho]]).astype(np.int32)
    hi = np.concatenate([np.maximum(a, b), [rho, 0, rho]]).astype(np.int32)
    tree = [got_tree.count_less(int(x), int(y), m) for x, y in zip(lo, hi)]
    assert tree == [want_tree.count_less(int(x), int(y), m) for x, y in zip(lo, hi)]
    assert tree == [int((vilcp[x:y] < m).sum()) for x, y in zip(lo, hi)]
    wm = wm_count_less(t.wm, torch.from_numpy(lo), torch.from_numpy(hi),
                       torch.full(lo.shape, m, dtype=torch.int32))
    np.testing.assert_array_equal(wm.numpy(), tree)


# ---------------------------------------------------------------------------
# Validation and fingerprints
# ---------------------------------------------------------------------------


def _port_array(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def _mutated(jobj, tobj, field, fn):
    old = getattr(jobj, field)
    if isinstance(old, int):
        return jreplace(jobj, **{field: fn(old)}), dataclasses.replace(tobj, **{field: fn(old)})
    new = fn(np.asarray(old))
    return jreplace(jobj, **{field: new}), dataclasses.replace(tobj, **{field: _port_array(new)})


def _same_message(jfn, tfn, jobj, tobj):
    with pytest.raises(JIntegrity) as want:
        jfn(jobj)
    with pytest.raises(TIntegrity) as got:
        tfn(tobj)
    assert str(got.value) == str(want.value)


def _set(a, i, v):
    a = np.array(a, copy=True)
    a[i] = v
    return a


RLE_MUTATIONS = {
    "length": ("run_starts", lambda a: a[:-1]),
    "tiling": ("run_starts", lambda a: _set(a, -1, int(a[-1]) + 1)),
    "reorder": ("run_starts", lambda a: _set(a, 1, int(a[2]))),
    "decode": ("ones_prefix", lambda a: _set(a, -1, int(a[-1]) + 1)),
    "m": ("m", lambda v: v + 1),
}


@pytest.mark.parametrize("which", list(RLE_MUTATIONS))
def test_rle_mutations_are_caught(data, which):
    want = jsada.build_sada(data["jdata"], "rle")
    got = tsada.build_sada(data["tdata"], "rle")
    assert got.hp.nruns >= 3, "fixture H' too degenerate"
    tval.validate_sada(got)
    field, fn = RLE_MUTATIONS[which]
    jhp, thp = _mutated(want.hp, got.hp, field, fn)
    _same_message(lambda bv: jval.validate_rle_bitvector(bv, "hp"),
                  lambda bv: tval.validate_rle_bitvector(bv, "hp"), jhp, thp)
    _same_message(jval.validate_sada, tval.validate_sada, jreplace(want, hp=jhp),
                  dataclasses.replace(got, hp=thp))


@pytest.mark.parametrize("variant", ["filter_plain", "sparse_sparse"])
@pytest.mark.parametrize("which", ["hp_ones", "fs_order", "f1_range"])
def test_filter_variant_mutations_are_caught(data, variant, which):
    want = jsada.build_sada(data["jdata"], variant)
    got = tsada.build_sada(data["tdata"], variant)
    tval.validate_sada(got)
    if which == "hp_ones":  # one filtered slot fewer: H' no longer matches F_S
        jfs, tfs = _mutated(want.fs, got.fs, "pos", lambda a: a[:-1])
        jfs, tfs = _mutated(jfs, tfs, "m", lambda v: v - 1)
        jobj, tobj = jreplace(want, fs=jfs), dataclasses.replace(got, fs=tfs)
    elif which == "fs_order":
        assert got.fs.m >= 2
        jfs, tfs = _mutated(want.fs, got.fs, "pos", lambda a: _set(a, 1, int(a[0])))
        jobj, tobj = jreplace(want, fs=jfs), dataclasses.replace(got, fs=tfs)
    else:
        jf1, tf1 = _mutated(want.f1, got.f1, "pos", lambda a: _set(a, 0, -1))
        jobj, tobj = jreplace(want, f1=jf1), dataclasses.replace(got, f1=tf1)
        if got.f1.m == 0:  # the placeholder is not read: nothing to catch
            tval.validate_sada(tobj)
            return
    _same_message(jval.validate_sada, tval.validate_sada, jobj, tobj)


@pytest.mark.parametrize("variant", jsada.VARIANTS)
def test_sada_fingerprint_per_variant(data, variant):
    want = jsada.build_sada(data["jdata"], variant)
    got = tsada.build_sada(data["tdata"], variant)
    tval.validate_sada(got)
    assert tval.checksum(got) == jval.checksum_pytree(want)


@pytest.fixture(scope="module")
def tiny():
    coll = jcoll.generate(jcoll.SyntheticSpec("version", n_base=2, n_variants=3, base_len=40,
                                              mutation_rate=0.01, seed=1))
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts, doc_ends=coll.doc_ends,
                       d=coll.d, sigma=coll.sigma)
    pats = jcoll.random_substring_patterns(coll, 200, 3, 16)
    return coll, tcoll, jbuild_suffix_data(coll), pats


@pytest.mark.parametrize("variant", jsada.VARIANTS)
def test_service_builds_every_variant(tiny, variant):
    """``RetrievalService.build(sada_variant=...)`` takes all five, as the
    reference's does: the build validates the variant, its fingerprint is
    the reference's, and ``count`` gives the distinct documents."""
    from repro_torch.serve.retrieval import RetrievalService

    coll, tcoll, jdata, pats = tiny
    svc = RetrievalService.build(tcoll, block_size=16, beta=8.0, sada_variant=variant,
                                 topk_index=False, device="cpu")
    assert svc.sada.variant == variant
    assert svc.fingerprints["sada"] == jval.checksum_pytree(jsada.build_sada(jdata, variant))
    plan = svc.plan(pats)
    da = jdata.da
    want = [len(set(da[a:b].tolist())) for a, b in zip(plan["lo"], plan["hi"])]
    np.testing.assert_array_equal(svc.count(pats), want)
