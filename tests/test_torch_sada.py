"""Sadakane's counting structure: the port's ``build_sada`` against the
reference's, per variant.

A bare ``build_sada(data)`` must build the reference's default variant,
``"plain"``, with the reference's ``modeled_bits``, bit words and counts;
``"plain"`` and ``"sparse"`` asked for by name likewise.  Counts are held
on pattern ranges (suffix-tree node ranges, the structure's contract) and
on seeded arbitrary ranges, where both packages evaluate the same select
formula.  The reference's plain structure carried across by
``repro_torch.convert`` keeps its bitvector type and counts.
"""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sada as jsada
from repro.core.suffix import build_suffix_data as jbuild_suffix_data
from repro.core.suffix import sa_range_for_pattern
from repro.data import collections as jcoll
from repro_torch import convert
from repro_torch.core import sada as tsada
from repro_torch.core.suffix import Collection, build_suffix_data
from repro_torch.succinct.bitvector import PlainBitvector, SparseBitvector


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


def _fields(obj):
    """Field dict of a reference index object, arrays as numpy."""
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
def data(request):
    coll = jcoll.generate(SPECS[request.param])
    jdata = jbuild_suffix_data(coll)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tdata = build_suffix_data(tcoll, "cpu")
    ranges = [sa_range_for_pattern(jdata, p)
              for p in jcoll.random_substring_patterns(coll, 200, 1, 30, seed=4)]
    rng = np.random.default_rng(8)
    a = rng.integers(0, coll.n + 1, 300)
    b = rng.integers(0, coll.n + 1, 300)
    ranges += list(zip(np.minimum(a, b), np.maximum(a, b)))
    ranges += [(0, 0), (0, coll.n), (coll.n - 1, coll.n), (7, 3), (0, 1)]
    lo = np.asarray([r[0] for r in ranges], np.int32)
    hi = np.asarray([r[1] for r in ranges], np.int32)
    return jdata, tdata, lo, hi


def _counts_ref(s, lo, hi):
    return np.asarray(jsada.sada_count_batch(s, jnp.asarray(lo), jnp.asarray(hi)))


def _counts_port(s, lo, hi):
    got = tsada.sada_count_batch(s, torch.from_numpy(lo), torch.from_numpy(hi))
    assert got.dtype == torch.int32
    return got.numpy()


@pytest.mark.parametrize("variant", [None, "plain", "sparse"])
def test_build_sada_matches_reference(data, variant):
    """Same variant, slots, modeled size, bitvector and counts."""
    jdata, tdata, lo, hi = data
    args = () if variant is None else (variant,)
    want = jsada.build_sada(jdata, *args)
    got = tsada.build_sada(tdata, *args)
    assert got.variant == want.variant == (variant or "plain")
    assert got.num_slots == want.num_slots and got.n == want.n
    assert got.modeled_bits() == want.modeled_bits()
    assert isinstance(got.hp, PlainBitvector if got.variant == "plain" else SparseBitvector)
    for f in dataclasses.fields(got.hp):
        w, g = getattr(want.hp, f.name), getattr(got.hp, f.name)
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int32), f.name)
        else:
            assert g == w, f.name
    np.testing.assert_array_equal(_counts_port(got, lo, hi), _counts_ref(want, lo, hi))


def test_plain_sada_carried_across(data):
    """``convert.from_numpy`` rebuilds the reference's plain structure as a
    plain bitvector, with the reference's counts."""
    jdata, _, lo, hi = data
    want = jsada.build_sada(jdata)
    got = convert.from_numpy(tsada.SadaCount, _fields(want), "cpu")
    assert isinstance(got.hp, PlainBitvector) and got.variant == "plain"
    assert got.modeled_bits() == want.modeled_bits()
    np.testing.assert_array_equal(_counts_port(got, lo, hi), _counts_ref(want, lo, hi))


def test_unported_variant_refused(data):
    """Every variant of the reference is ported; a name outside ``VARIANTS``
    is refused."""
    assert tsada.VARIANTS == jsada.VARIANTS
    with pytest.raises(ValueError):
        tsada.build_sada(data[1], "rle_sparse")
