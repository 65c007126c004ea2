"""ROADMAP queue C: fault C1 repaired, divergences C2 and C3 pinned.

* C1. ``count`` with an engine name the planner does not know: the
  reference's ``count`` plans without the engine and returns df, and so
  do the port's flat and sharded services now.
* C2. ``list_docs_arrays`` with ``max_df=0``: the reference's batched
  program raises ``IndexError``; the port answers (B, 0) rows and zero
  counts.  The per-query engine: ``reference:pdl`` answers ``[[]] * B``
  in both packages and ``reference:brute`` every document of each range
  in both; ``reference:ilcp`` raises ``IndexError`` in the reference and
  answers ``[[]] * B`` in the port.  The sharded service's host merge
  cuts every row to ``max_df``, so its reference path answers
  ``[[]] * B`` for every sub-engine.
* C3. ``topk`` with ``k > max_buf``: both raise, the reference
  ``ValueError`` and the port ``RuntimeError``.

The collection is the reference runtime tests' (``version``, n_base 2,
n_variants 6, base_len 80, seed 3).
"""

import numpy as np
import pytest
import torch

from repro.data.collections import SyntheticSpec, generate, random_substring_patterns
from repro.serve.retrieval import RetrievalService as JService
from repro.serve.sharded import ShardedRetrievalService as JSharded
from repro_torch.core.suffix import Collection
from repro_torch.dist.sharding import make_docs_mesh
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
def sides():
    coll = generate(SyntheticSpec("version", n_base=2, n_variants=6, base_len=80,
                                  mutation_rate=0.01, seed=3))
    jsvc = JService.build(coll, block_size=16, beta=8.0, validate=False)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts, doc_ends=coll.doc_ends,
                       d=coll.d, sigma=coll.sigma)
    flat = TService.build(tcoll, block_size=16, beta=8.0, device="cpu")
    sharded = TService.build(tcoll, mesh=make_docs_mesh(3, "cpu"), block_size=16, beta=8.0,
                             device="cpu")
    pats = random_substring_patterns(coll, 40, 4, 12)
    return jsvc, {"flat": flat, "sharded": sharded}, pats


@pytest.mark.parametrize("which", ["flat", "sharded"])
@pytest.mark.parametrize("engine", ["bogus", "", "Auto", "reference_x"])
def test_count_ignores_an_unknown_engine(sides, which, engine):
    jsvc, ports, pats = sides
    want = jsvc.count(pats, engine=engine)
    np.testing.assert_array_equal(want, jsvc.count(pats))
    got = ports[which].count(pats, engine=engine)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("which", ["flat", "sharded"])
def test_unknown_engine_still_refused_where_it_selects_one(sides, which):
    """Only ``count`` ignores the name; the endpoints that dispatch on it
    refuse it, as the reference's do."""
    jsvc, ports, pats = sides
    with pytest.raises(KeyError):
        jsvc.list_docs_arrays(pats[:2], engine="bogus")
    with pytest.raises(KeyError):
        ports[which].list_docs_arrays(pats[:2], engine="bogus")


@pytest.mark.parametrize("which", ["flat", "sharded"])
def test_c2_max_df_zero(sides, which):
    jsvc, ports, pats = sides
    with pytest.raises(IndexError):
        jsvc.list_docs_arrays(pats[:5], max_df=0)
    docs, cnt = ports[which].list_docs_arrays(pats[:5], max_df=0)
    assert docs.shape == (5, 0) and docs.dtype == np.int32
    np.testing.assert_array_equal(cnt, np.zeros(5, np.int32))
    assert ports[which].list_docs(pats[:5], max_df=0) == [[]] * 5


@pytest.mark.parametrize("sub", ["brute", "ilcp", "pdl"])
def test_c2_max_df_zero_reference_engine(sides, sub):
    jsvc, ports, pats = sides
    pats = pats[:2]  # the reference's per-query engine runs op by op here
    engine, max_buf = f"reference:{sub}", 64
    got = ports["flat"].list_docs(pats, max_df=0, engine=engine, max_buf=max_buf)
    if sub == "ilcp":
        with pytest.raises(IndexError):
            jsvc.list_docs(pats, max_df=0, engine=engine, max_buf=max_buf)
        assert got == [[]] * 2
    else:
        assert got == jsvc.list_docs(pats, max_df=0, engine=engine, max_buf=max_buf)
        assert (got == [[]] * 2) == (sub == "pdl")
    # the reference's host merge, run over the port's shards
    sharded = ports["sharded"]
    want = JSharded._list_docs_reference(sharded, pats, 0, sub, max_buf)
    assert sharded.list_docs(pats, max_df=0, engine=engine, max_buf=max_buf) == want == [[]] * 2


@pytest.mark.parametrize("which", ["flat", "sharded"])
def test_c3_k_above_max_buf(sides, which):
    jsvc, ports, pats = sides
    with pytest.raises(ValueError):
        jsvc.topk_arrays(pats[:4], k=20, engine="pdl", max_buf=16)
    with pytest.raises(RuntimeError):
        ports[which].topk_arrays(pats[:4], k=20, engine="pdl", max_buf=16)
