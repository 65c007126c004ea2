"""ROADMAP C17 repaired: an endpoint knob below its floor is refused with
one ``ValueError`` that names it, on every engine of the flat and the
docs-sharded service, before any engine or program runs.

* ``list_docs(max_df=-1)``: the reference raises ``TypeError`` on every
  engine (``broadcast_in_dim`` of a negative shape); the port raised
  ``RuntimeError`` and answered ``[[]] * B`` on ``reference:ilcp``.
* ``topk(k=-1)``: the reference raises ``TypeError``, or ``ValueError`` on
  ``reference:ilcp`` and ``reference:pdl``; the port raised
  ``RuntimeError``.
* ``topk(max_buf=0)``: the reference raises ``ValueError``, except on
  ``reference`` and ``reference:brute``, which answer ``[[]] * B`` (as the
  port did); the port raised ``RuntimeError`` elsewhere.  The port now
  refuses it on every engine.
* ``list_docs(max_buf=0)`` stays answered in both packages (no knob is
  below a floor there), and ``tfidf`` is left as it was (it agreed).

The reference's sharded service fails under this JAX (C16), so the
sharded side asserts the port's refusal alone.  ``ServeRuntime`` over such
a config: ``list`` at ``max_df=-1`` and ``topk`` at ``k=-1`` fall to the
floor rung, whose own ``floor_max_df`` / ``floor_k`` answer, as before;
``topk`` at ``max_buf=0`` fails every rung now and answers ``[]`` on the
``empty`` rung, where the per-query rung answered the same ``[]`` before
(the reference's runtime answers it there).

The collection is ``tests/test_torch_serve.py``'s ``"version"`` (n_base
3, n_variants 7, base_len 90, mutation rate 0.01, seed 5), built with
block size 16 and beta 8.0.
"""

import numpy as np
import pytest
import torch

from repro.data.collections import SyntheticSpec, generate, random_substring_patterns
from repro.serve import runtime as jruntime
from repro.serve.retrieval import RetrievalService as JService
from repro_torch.core.suffix import Collection
from repro_torch.dist.sharding import make_docs_mesh
from repro_torch.serve import runtime as truntime
from repro_torch.serve.retrieval import RetrievalService as TService


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENGINES = ["auto", "brute", "ilcp", "pdl", "reference", "reference:brute", "reference:ilcp",
           "reference:pdl"]
#: (endpoint, knobs, the port's message)
CASES = [("list_docs", {"max_df": -1}, "max_df must be >= 0, got -1"),
         ("topk", {"k": -1}, "k must be >= 0, got -1"),
         ("topk", {"max_buf": 0}, "max_buf must be >= 1, got 0")]
CASE_IDS = ["list-max_df", "topk-k", "topk-max_buf"]


def _reference_answer(endpoint, knobs, engine):
    """The reference's exception type for a knob below its floor on
    ``engine``, or None where it answers (module docstring)."""
    if endpoint == "list_docs":
        return TypeError
    if "k" in knobs:
        return ValueError if engine in ("reference:ilcp", "reference:pdl") else TypeError
    return None if engine in ("reference", "reference:brute") else ValueError


@pytest.fixture(scope="module")
def sides():
    coll = generate(SyntheticSpec("version", n_base=3, n_variants=7, base_len=90,
                                  mutation_rate=0.01, seed=5))
    jsvc = JService.build(coll, block_size=16, beta=8.0, validate=False)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts, doc_ends=coll.doc_ends,
                       d=coll.d, sigma=coll.sigma)
    flat = TService.build(tcoll, block_size=16, beta=8.0, device="cpu")
    sharded = TService.build(tcoll, mesh=make_docs_mesh(3, "cpu"), block_size=16, beta=8.0,
                             device="cpu")
    pats = random_substring_patterns(coll, 40, 4, 12)[:3]
    return jsvc, {"flat": flat, "sharded": sharded}, pats


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_flat_service_refuses_beside_the_reference(sides, case, engine):
    jsvc, ports, pats = sides
    endpoint, knobs, message = case
    want = _reference_answer(endpoint, knobs, engine)
    # the reference's per-query engines run op by op here: one pattern
    jpats = pats[:1] if engine.startswith("reference") else pats
    if want is None:
        assert getattr(jsvc, endpoint)(jpats, engine=engine, **knobs) == [[]] * len(jpats)
    else:
        with pytest.raises(want):
            getattr(jsvc, endpoint)(jpats, engine=engine, **knobs)
    port = ports["flat"]
    before = dict(port.compile_counts)
    with pytest.raises(ValueError, match=message):
        getattr(port, endpoint)(pats, engine=engine, **knobs)
    if not engine.startswith("reference"):
        with pytest.raises(ValueError, match=message):
            getattr(port, f"{endpoint}_arrays")(pats, engine=engine, **knobs)
    assert port.compile_counts == before  # refused before any program


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_service_refuses(sides, case, engine):
    _, ports, pats = sides
    endpoint, knobs, message = case
    port = ports["sharded"]
    before = dict(port.compile_counts)
    with pytest.raises(ValueError, match=message):
        getattr(port, endpoint)(pats, engine=engine, **knobs)
    if not engine.startswith("reference"):
        with pytest.raises(ValueError, match=message):
            getattr(port, f"{endpoint}_arrays")(pats, engine=engine, **knobs)
        # an empty batch is refused too: the knob is checked first
        with pytest.raises(ValueError, match=message):
            getattr(port, f"{endpoint}_arrays")([], engine=engine, **knobs)
    assert port.compile_counts == before


@pytest.mark.parametrize("which", ["flat", "sharded"])
def test_knobs_at_their_floor_still_answer(sides, which):
    """``max_df=0`` (C2), ``k=0``, ``max_buf=1`` and ``list_docs``'s
    ``max_buf=0`` are in range and answered."""
    _, ports, pats = sides
    port = ports[which]
    assert port.list_docs(pats, max_df=0) == [[]] * len(pats)
    assert port.topk(pats, k=0) == [[]] * len(pats)
    docs, _ = port.topk_arrays(pats, k=1, max_buf=1)
    assert docs.shape == (len(pats), 1)
    assert port.list_docs(pats, max_buf=0) == port.list_docs(pats, max_buf=0, engine="reference")


#: (request kind, knobs, the rung that answers)
LADDER = [("list", {"max_df": -1}, "floor"), ("topk", {"k": -1}, "floor"),
          ("list", {"max_buf": 0}, "full"), ("topk", {"max_buf": 0}, "empty")]


@pytest.mark.parametrize("kind,knobs,path", LADDER,
                         ids=["list-max_df", "topk-k", "list-max_buf", "topk-max_buf"])
def test_runtime_ladder(sides, kind, knobs, path):
    """The flat service under ``ServeRuntime`` with a knob out of range:
    the rung that answers and its answers, the floor's those of a direct
    call at the floor's knobs; the reference's runtime answers ``topk`` at
    ``max_buf=0`` on its per-query rung instead, with the same ``[]``."""
    jsvc, ports, pats = sides
    svc = ports["flat"]
    cfg = truntime.RuntimeConfig(default_deadline_s=None, **knobs)
    answers = truntime.ServeRuntime(svc, cfg, sleep=lambda s: None).serve(
        [(kind, p) for p in pats])
    assert [a.path for a in answers] == [path] * len(pats)
    got = [a.result for a in answers]
    if path == "floor" and kind == "list":
        assert got == svc.list_docs(pats, max_df=cfg.floor_max_df, engine="brute",
                                    max_buf=cfg.max_buf)
    elif path == "floor":
        assert got == svc.topk(pats, k=cfg.floor_k, engine="brute", max_buf=cfg.max_buf)
    elif path == "full":
        assert got == svc.list_docs(pats, max_buf=0)
    else:
        assert got == [[]] * len(pats)
        jcfg = jruntime.RuntimeConfig(default_deadline_s=None, **knobs)
        janswers = jruntime.ServeRuntime(jsvc, jcfg, sleep=lambda s: None).serve(
            [(kind, np.asarray(p)) for p in pats])
        assert [(a.path, a.result) for a in janswers] == [("reference", [])] * len(pats)
