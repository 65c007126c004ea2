"""The port's index validation against the reference's.

Both packages build the reference validation tests' collection
(``version``, n_base 2, n_variants 6, base_len 90, seed 7).  The port's
fingerprints must equal the reference's ``checksum_pytree`` for every
structure the two share bit for bit, and each mutation of
``tests/test_serve_validate.py``, applied to the same field of both
indexes, must raise ``IndexIntegrityError`` with the reference's message
on both (the hypothesis draws there are seeded numpy draws here, each its
own case).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.common import replace as jreplace
from repro.core import sada as jsada
from repro.core.suffix import build_suffix_data as jbuild_suffix_data
from repro.data.collections import SyntheticSpec, generate
from repro.errors import IndexIntegrityError as JIntegrity
from repro.serve import validate as jval
from repro.serve.retrieval import RetrievalService as JService
from repro_torch.core import sada as tsada
from repro_torch.core.suffix import Collection, build_suffix_data
from repro_torch.errors import IndexIntegrityError as TIntegrity
from repro_torch.serve import validate as tval
from repro_torch.serve.retrieval import RetrievalService as TService


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def svcs():
    coll = generate(SyntheticSpec("version", n_base=2, n_variants=6,
                                  base_len=90, mutation_rate=0.01, seed=7))
    jsvc = JService.build(coll, block_size=16, beta=8.0)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tsvc = TService.build(tcoll, block_size=16, beta=8.0, device="cpu")
    return jsvc, tsvc


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def test_build_validates_and_stores_fingerprints(svcs):
    _, tsvc = svcs
    fps = tval.validate_service(tsvc)
    assert fps == tval.fingerprint_service(tsvc) == tsvc.fingerprints
    assert sorted(fps) == ["csa", "da", "ilcp", "pdl_list", "pdl_topk", "sada"]
    assert tsvc.build_seconds["validate"] > 0
    tval.verify_fingerprints(tsvc, fps)


@pytest.mark.parametrize("comp", ["csa", "ilcp", "pdl_list", "pdl_topk", "da"])
def test_fingerprint_equals_reference(svcs, comp):
    """CRC32 over the tensors in field order equals the reference's CRC32
    over its pytree leaves: the same arrays, bit for bit, in one order."""
    jsvc, tsvc = svcs
    assert tsvc.fingerprints[comp] == jsvc.fingerprints[comp]
    assert tval.checksum(getattr(tsvc, comp)) == jval.checksum_pytree(getattr(jsvc, comp))


@pytest.mark.parametrize("variant", jsada.VARIANTS)
def test_sada_fingerprint_is_that_of_hp(svcs, variant):
    """Sada's fingerprint equals the reference's for every variant: the
    port's Sada holds ``hp`` and the two filters ``fs`` and ``f1`` (one-entry
    placeholders where the variant reads none), the reference's arrays in
    its order.  (The name dates from when the port kept only ``hp``.)"""
    jsvc, tsvc = svcs
    if variant == "sparse":  # what both services build
        assert tsvc.fingerprints["sada"] == jsvc.fingerprints["sada"]
    want = jsada.build_sada(jbuild_suffix_data(jsvc.coll), variant)
    got = tsada.build_sada(build_suffix_data(tsvc.coll, "cpu"), variant)
    tval.validate_sada(got)
    assert tval.checksum(got) == jval.checksum_pytree(want)
    assert tval.checksum(got) != tval.checksum(got.hp)


def test_service_without_topk_index_skips_it():
    coll = generate(SyntheticSpec("version", n_base=2, n_variants=3,
                                  base_len=40, mutation_rate=0.01, seed=1))
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tsvc = TService.build(tcoll, block_size=16, beta=8.0, topk_index=False, device="cpu")
    assert sorted(tsvc.fingerprints) == ["csa", "da", "ilcp", "pdl_list", "sada"]
    assert "validate" in tsvc.build_seconds
    nov = TService.build(tcoll, block_size=16, beta=8.0, validate=False, device="cpu")
    assert nov.fingerprints == {} and "validate" not in nov.build_seconds


def test_wm_histogram_matches_reference(svcs):
    jsvc, tsvc = svcs
    hist = tval.wm_symbol_histogram(tsvc.csa.wm)
    assert hist.dtype == np.int64
    np.testing.assert_array_equal(hist, jval.wm_symbol_histogram(jsvc.csa.wm))
    np.testing.assert_array_equal(hist, np.diff(tsvc.csa.counts.numpy()))


# ---------------------------------------------------------------------------
# Mutations: the same corruption of both indexes, the same message
# ---------------------------------------------------------------------------


def _mut(arr, idx, val):
    out = np.array(arr, copy=True)
    out[idx] = val
    return out


def _port_array(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def _both(svcs, path, field, fn):
    """(reference object, port object) at ``path`` of the service with
    ``field`` replaced by ``fn`` of the reference's array (a metadata
    field's new value where ``fn`` takes and returns an int)."""
    jsvc, tsvc = svcs
    jobjs, tobjs = [jsvc], [tsvc]
    for name in path:
        jobjs.append(getattr(jobjs[-1], name))
        tobjs.append(getattr(tobjs[-1], name))
    old = getattr(jobjs[-1], field)
    if isinstance(old, int):
        jnew = tnew = fn(old)
    else:
        jnew = fn(np.asarray(old))
        tnew = _port_array(jnew)
    jobj = jreplace(jobjs[-1], **{field: jnew})
    tobj = dataclasses.replace(tobjs[-1], **{field: tnew})
    for name, jp, tp in zip(reversed(path[1:]), reversed(jobjs[1:-1]), reversed(tobjs[1:-1])):
        jobj = jreplace(jp, **{name: jobj})
        tobj = dataclasses.replace(tp, **{name: tobj})
    return jobj, tobj


def _same_message(jfn, tfn, jobj, tobj):
    with pytest.raises(JIntegrity) as want:
        jfn(jobj)
    with pytest.raises(TIntegrity) as got:
        tfn(tobj)
    assert str(got.value) == str(want.value)
    return str(got.value)


def _bit_flips(k=12, seed=0):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 3)), int(rng.integers(0, 1 << 20))) for _ in range(k)]


@pytest.mark.parametrize("lvl,bit", _bit_flips(), ids=lambda x: str(x))
def test_any_wm_bit_flip_is_caught(svcs, lvl, bit):
    wm = svcs[0].csa.wm
    lvl %= wm.levels
    bit %= np.asarray(wm.words).shape[1] * 32

    def flip(words):
        words = np.array(words, copy=True)
        words[lvl, bit // 32] ^= np.uint32(1) << np.uint32(bit % 32)
        return words

    jcsa, tcsa = _both(svcs, ["csa", "wm"], "words", flip)
    _same_message(jval.validate_csa, tval.validate_csa, jcsa, tcsa)


def _wm_metadata(k=10, seed=1):
    rng = np.random.default_rng(seed)
    fields = ["zcount", "ones_prefix", "sym_starts"]
    return [(fields[i % 3], int(rng.integers(0, 1 << 20)), int(rng.integers(0, 1 << 20)),
             [-2, -1, 1, 3][int(rng.integers(0, 4))]) for i in range(k)]


@pytest.mark.parametrize("field,a,b,delta", _wm_metadata(), ids=lambda x: str(x))
def test_wm_metadata_corruption_is_caught(svcs, field, a, b, delta):
    wm = svcs[0].csa.wm

    def corrupt(arr):
        arr = np.array(arr, copy=True)
        if field == "ones_prefix":
            arr[a % wm.levels, 1 + b % (arr.shape[1] - 1)] += delta
        else:
            arr[a % arr.shape[0]] += delta
        return arr

    jcsa, tcsa = _both(svcs, ["csa", "wm"], field, corrupt)
    _same_message(jval.validate_csa, tval.validate_csa, jcsa, tcsa)


def _c_array_mutations():
    return [
        lambda c, csa: _mut(c, 0, 1),                       # C[0] != 0
        lambda c, csa: _mut(c, 1, csa.d + 1),               # C[1] != d
        lambda c, csa: _mut(c, len(c) - 1, csa.n + 1),      # C[sigma] > n
        lambda c, csa: c[:-1],                              # wrong length
    ]


@pytest.mark.parametrize("which", range(4))
def test_csa_c_array_corruptions(svcs, which):
    fn = _c_array_mutations()[which]
    jcsa, tcsa = _both(svcs, ["csa"], "counts", lambda c: fn(c, svcs[0].csa))
    _same_message(jval.validate_csa, tval.validate_csa, jcsa, tcsa)


def test_csa_sample_out_of_range(svcs):
    n = svcs[0].csa.n
    jcsa, tcsa = _both(svcs, ["csa"], "samples", lambda s: _mut(s, 0, n))
    assert "SA sample" in _same_message(jval.validate_csa, tval.validate_csa, jcsa, tcsa)


def _ilcp_mutations(k=3, seed=2):
    rng = np.random.default_rng(seed)
    return [(which, int(rng.integers(0, 1 << 20)))
            for which in ("bounds", "maximality", "clens", "vro") for _ in range(k)]


@pytest.mark.parametrize("which,r", _ilcp_mutations(), ids=lambda x: str(x))
def test_ilcp_mutations_are_caught(svcs, which, r):
    ilcp = svcs[0].ilcp
    assert ilcp.nruns >= 2, "fixture collection too degenerate"
    idx = 1 + r % (ilcp.nruns - 1)
    field, fn = {
        "bounds": ("run_starts", lambda a: _mut(a, idx, int(a[idx - 1]))),
        "maximality": ("vilcp", lambda a: _mut(a, idx, int(a[idx - 1]))),
        "clens": ("clens", lambda a: _mut(a, idx, int(a[idx - 1]))),
        "vro": ("value_run_offset", lambda a: _mut(a, len(a) - 1, ilcp.nruns + 1)),
    }[which]
    jobj, tobj = _both(svcs, ["ilcp"], field, fn)
    _same_message(jval.validate_ilcp, tval.validate_ilcp, jobj, tobj)


@pytest.mark.parametrize("which", ["set_off", "leaf_starts", "A"])
def test_pdl_mutations_are_caught(svcs, which):
    pdl = svcs[0].pdl_list
    fn = {
        "set_off": lambda a: _mut(a, len(a) - 1, int(a[-1]) + 7),
        "leaf_starts": lambda a: _mut(a, 0, 1),
        "A": lambda a: _mut(a, 0, pdl.d + pdl.nrules + 5),
    }[which]
    jobj, tobj = _both(svcs, ["pdl_list"], which, fn)
    msg = _same_message(lambda p: jval.validate_pdl(p), lambda p: tval.validate_pdl(p),
                        jobj, tobj)
    assert {"set_off": "set_off", "leaf_starts": "leaves", "A": "grammar symbol"}[which] in msg


def test_sada_slot_count_mismatch(svcs):
    jobj, tobj = _both(svcs, ["sada"], "num_slots", lambda v: v + 1)
    assert "num_slots" in _same_message(jval.validate_sada, tval.validate_sada, jobj, tobj)


def test_fingerprint_catches_invariant_preserving_corruption(svcs):
    jsvc, tsvc = svcs
    d = jsvc.coll.d
    jbad, tbad = _both(svcs, [], "da", lambda da: _mut(da, 0, (int(da[0]) + 1) % d))
    assert tval.validate_service(tbad) != tsvc.fingerprints  # structurally fine
    with pytest.raises(JIntegrity) as want:
        jval.verify_fingerprints(jbad, jsvc.fingerprints)
    with pytest.raises(TIntegrity) as got:
        tval.verify_fingerprints(tbad, tsvc.fingerprints)
    assert str(got.value) == str(want.value)
    assert "checksum mismatch in: da" in str(got.value)
