"""The port's recsys models (FM, SASRec, AutoInt, DLRM-MLPerf) against the
reference, on the CPU.

Each model at its ``reduced_config()``, on the reference's weights
(``*_init`` under ``jax.random.PRNGKey(0)``, carried over by
``recsys_params_from_numpy``) and numpy-seeded batches
(``recsys_batches``):

- the init's layout against ``jax.eval_shape`` of the reference's init, at
  the reduced and the full config (the port's on ``meta`` tensors), and
  ``_embed_init``'s padding at 70,000 rows;
- ``_field_offsets``, ``_criteo_like_sizes``, ``MLPERF_TABLE_SIZES`` and
  ``_dot_interaction``'s pair order;
- ``*_logits`` / ``sasrec_serve`` and every ``*_retrieval`` in f32, and
  with the tables cast to bf16 in both packages (the registry's serving
  rule, tables in bf16 and the rest in f32, applied by hand: the reduced
  tables are below its 65,536-row threshold), a SASRec sequence that
  starts with padding among the batch;
- ``lookup`` against ``jnp.take``, and the lookups each entry point makes
  (one embedding-bag launch each on the card);
- the gap between each model's retrieval scores and its logits on the same
  user with the candidate filled in, in the reference, with bf16 tables:
  the tolerance that ``chip_smoke.py`` holds the port to on the card.

Tolerances: f32 outputs within rtol 1e-5 / atol 1e-6 (summation order;
measured at most 9e-8).  With bf16 tables the output dtypes equal the
reference's and the values lie within one bf16 ulp of the output's largest
magnitude (2^-8 of it): both packages gather the same bf16 rows, and the
bf16 sums they form may round in another order (measured at most 6e-8
against outputs of about 0.4).  ``lookup`` is exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import autoint as jax_autoint
from repro.configs import dlrm_mlperf as jax_dlrm
from repro.configs import fm as jax_fm
from repro.configs import sasrec as jax_sasrec
from repro.models import recsys as J
from repro_torch.configs import autoint, dlrm_mlperf, fm, sasrec
from repro_torch.convert import recsys_params_from_numpy
from repro_torch.data.pipelines import recsys_batches
from repro_torch.models import recsys as T
from repro_torch.train.tree import flatten, treedef_str


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = {"fm": (jax_fm, fm), "sasrec": (jax_sasrec, sasrec), "autoint": (jax_autoint, autoint),
         "dlrm-mlperf": (jax_dlrm, dlrm_mlperf)}
INIT = {"fm": "fm_init", "sasrec": "sasrec_init", "autoint": "autoint_init",
        "dlrm-mlperf": "dlrm_init"}
#: each model's embedding tables, bf16 in the serving copy
TABLES = {"fm": ("emb", "lin"), "sasrec": ("item_emb",), "autoint": ("emb",),
          "dlrm-mlperf": ("emb",)}
DTYPES = ("f32", "bf16")
F32_RTOL, F32_ATOL = 1e-5, 1e-6
BF16_REL = 2.0 ** -8
#: retrieval against logits with bf16 tables: at most 4 bf16 ulps of the
#: largest score (chip_smoke.py's RECSYS_GAP_REL)
GAP_REL = 2.0 ** -6
B = 8
#: lookups (embedding-bag launches on the card) per call of each entry point
LOOKUPS = {
    ("fm", "logits"): 2, ("fm", "retrieval"): 4, ("fm", "train"): 2,
    ("sasrec", "logits"): 2, ("sasrec", "retrieval"): 2, ("sasrec", "train"): 3,
    ("autoint", "logits"): 1, ("autoint", "retrieval"): 2, ("autoint", "train"): 1,
    ("dlrm-mlperf", "logits"): 1, ("dlrm-mlperf", "retrieval"): 2, ("dlrm-mlperf", "train"): 1,
}


def _bf16_tables(arch, params):
    """The reference's params with the tables in bf16."""
    return {k: v.astype(jnp.bfloat16) if k in TABLES[arch] else v for k, v in params.items()}


@functools.cache
def model(arch):
    """The reduced configs, the reference's weights (f32, and with bf16
    tables) and the port's copies of them."""
    jmod, tmod = ARCHS[arch]
    jcfg, tcfg = jmod.reduced_config(), tmod.reduced_config()
    jp = getattr(J, INIT[arch])(jcfg, jax.random.PRNGKey(0))
    jb = _bf16_tables(arch, jp)
    port = lambda p: recsys_params_from_numpy(  # noqa: E731
        tcfg, jax.tree.map(np.asarray, p), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jax={"f32": jp, "bf16": jb},
                port={"f32": port(jp), "bf16": port(jb)})


def batch(arch, seed=3, size=B):
    """A numpy batch of ``recsys_batches`` (SASRec: the first sequence
    starts with 4 padding positions, and ``target`` is added)."""
    cfg = model(arch)["tcfg"]
    if arch == "sasrec":
        b = next(recsys_batches((), size, seq_len=cfg.seq_len, n_items=cfg.n_items, seed=seed))
        b["item_seq"][0, :4] = 0
        b["target"] = b["pos_items"][:, -1].copy()
        return b
    return next(recsys_batches(cfg.vocab_sizes, size, n_dense=getattr(cfg, "n_dense", 0),
                               seed=seed))


def logits(pkg, arch, cfg, params, b):
    """The entry point that scores a batch: ``*_logits`` or
    ``sasrec_serve``, in the package ``pkg`` (``J`` or ``T``)."""
    x = (lambda a: jnp.asarray(a)) if pkg is J else torch.as_tensor
    if arch == "sasrec":
        return pkg.sasrec_serve(cfg, params, {"item_seq": x(b["item_seq"]),
                                              "target": x(b["target"])})
    if arch == "dlrm-mlperf":
        return pkg.dlrm_logits(cfg, params, x(b["dense"]), x(b["sparse"]))
    return getattr(pkg, f"{arch}_logits")(cfg, params, x(b["sparse"]))


def candidates(arch):
    """Every id of the candidate field (field 0; SASRec: every item)."""
    cfg = model(arch)["tcfg"]
    if arch == "sasrec":
        return np.arange(1, cfg.n_items + 1, dtype=np.int32)
    return np.arange(cfg.vocab_sizes[0], dtype=np.int32)


def retrieval(pkg, arch, cfg, params, b, cand, user=0):
    """``*_retrieval`` of batch row ``user`` against ``cand``."""
    x = (lambda a: jnp.asarray(a)) if pkg is J else torch.as_tensor
    if arch == "sasrec":
        return pkg.sasrec_retrieval(cfg, params, x(b["item_seq"][user:user + 1]), x(cand))
    if arch == "dlrm-mlperf":
        return pkg.dlrm_retrieval(cfg, params, x(b["dense"][user]), x(b["sparse"][user]),
                                  x(cand))
    return getattr(pkg, f"{arch}_retrieval")(cfg, params, x(b["sparse"][user]), x(cand))


def filled_in(arch, b, cand, user=0):
    """The batch of ``user`` with each candidate filled into its field, for
    the entry point that scores a batch."""
    n = len(cand)
    if arch == "sasrec":
        return {"item_seq": np.repeat(b["item_seq"][user:user + 1], n, 0), "target": cand}
    out = {"sparse": np.repeat(b["sparse"][user:user + 1], n, 0)}
    out["sparse"][:, 0] = cand
    if arch == "dlrm-mlperf":
        out["dense"] = np.repeat(b["dense"][user:user + 1], n, 0)
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_close(got, want, dtype):
    assert str(got.dtype).removeprefix("torch.") == jnp.dtype(want.dtype).name
    assert tuple(got.shape) == want.shape
    g, w = _np(got), _np(want)
    if dtype == "f32":
        np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_REL * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# layout and shared helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", (True, False), ids=("reduced", "full"))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_layout_matches_reference(arch, reduced):
    jmod, tmod = ARCHS[arch]
    jcfg = jmod.reduced_config() if reduced else jmod.config()
    tcfg = tmod.reduced_config() if reduced else tmod.config()
    want = jax.eval_shape(lambda: getattr(J, INIT[arch])(jcfg, jax.random.PRNGKey(0)))
    got = getattr(T, INIT[arch])(tcfg, None, device="meta")
    assert treedef_str(got) == str(jax.tree.structure(want))
    leaves, paths = flatten(got)
    jpaths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert paths == [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
                     for p, _ in jpaths]
    for g, (_, w) in zip(leaves, jpaths):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 and w.dtype == jnp.float32


def test_embed_init_pads_large_tables():
    for rows, padded in ((70_000, 70_656), (65_536, 65_536), (65_535, 65_535), (3, 3)):
        want = jax.eval_shape(lambda r=rows: J._embed_init(jax.random.PRNGKey(0), r, 3,
                                                           jnp.float32))
        got = T._embed_init(None, rows, 3, torch.float32, device="meta")
        assert tuple(got.shape) == want.shape == (padded, 3)
    gen = torch.Generator().manual_seed(0)
    t = T._embed_init(gen, 100, 4, torch.bfloat16, scale=0.5, device="cpu")
    assert t.dtype == torch.bfloat16 and 0.2 < float(t.float().std()) < 0.8


def test_shared_helpers_match_reference():
    assert T.MLPERF_TABLE_SIZES == J.MLPERF_TABLE_SIZES
    for n in (1, 5, 26, 39):
        assert T._criteo_like_sizes(n) == J._criteo_like_sizes(n)
    assert T._criteo_like_sizes(7, 1000) == J._criteo_like_sizes(7, 1000)
    for sizes in (J.MLPERF_TABLE_SIZES, (50, 60, 70), J._criteo_like_sizes(39)):
        got, total = T._field_offsets(sizes, device="cpu")
        want, jtotal = J._field_offsets(sizes)
        assert got.dtype == torch.int32 and total == jtotal
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("fm", "autoint"):
        assert model(name)["tcfg"].vocab_sizes == model(name)["jcfg"].vocab_sizes
    assert (T.FMConfig().vocab_sizes == J.FMConfig().vocab_sizes
            == T.AutoIntConfig().vocab_sizes)


@pytest.mark.parametrize("F", (2, 5, 27))
def test_dot_interaction_pair_order(F):
    iu, ju = jnp.triu_indices(F, k=1)
    t = torch.triu_indices(F, F, 1)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(iu))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(ju))
    z = np.random.default_rng(F).standard_normal((3, F, 4)).astype(np.float32)
    got = T._dot_interaction(torch.from_numpy(z))
    want = J._dot_interaction(jnp.asarray(z))
    assert tuple(got.shape) == want.shape == (3, F * (F - 1) // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL, atol=F32_ATOL)
    # each pair (i, j), i < j, in row-major order: z_i . z_j
    pairs = [(i, j) for i in range(F) for j in range(i + 1, F)]
    np.testing.assert_allclose(got.numpy(), np.stack(
        [np.einsum("bd,bd->b", z[:, i], z[:, j]) for i, j in pairs], axis=1), rtol=1e-5,
        atol=1e-5)


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_lookup_matches_take(dtype):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((97, 6)).astype(np.float32)
    jt = jnp.asarray(table, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tt = torch.from_numpy(table).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    for shape in ((7,), (3, 4), (2, 3, 5), (0,)):
        ids = rng.integers(0, 97, shape).astype(np.int32)
        got = T.lookup(tt, torch.from_numpy(ids))
        want = jnp.take(jt, jnp.asarray(ids), axis=0)
        assert got.dtype == tt.dtype and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_np(got), _np(want))
        assert torch.equal(got, tt[torch.from_numpy(ids).long()])
    # int64 ids, and the edges of the table
    ids = torch.tensor([0, 96, 5, 5], dtype=torch.int64)
    assert torch.equal(T.lookup(tt, ids), tt[ids])


def test_lookup_out_of_range_on_the_cpu():
    """On the CPU a negative id counts from the end, as in ``jnp.take``; an
    id past the table raises, where ``jnp.take`` fills NaN (ROADMAP C: on
    the card a negative id gives zeros and ids are not checked)."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    np.testing.assert_array_equal(
        T.lookup(table, torch.tensor([-1], dtype=torch.int32)).numpy(),
        np.asarray(jnp.take(jnp.asarray(table.numpy()), jnp.asarray([-1]), axis=0)))
    with pytest.raises(IndexError):
        T.lookup(table, torch.tensor([4], dtype=torch.int32))
    assert np.isnan(np.asarray(jnp.take(jnp.asarray(table.numpy()), jnp.asarray([4]),
                                        axis=0))).all()


def test_lookup_gradient_is_a_scatter_add():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((11, 3)).astype(np.float32)
    ids = np.array([[1, 4, 1], [10, 1, 0]], np.int32)
    w = rng.standard_normal((2, 3, 3)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jnp.take(t, jnp.asarray(ids), axis=0) * w))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(T.lookup(t, torch.from_numpy(ids)) *
                                           torch.from_numpy(w)), t)
    assert got.shape == t.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not got[[2, 3, 5, 6, 7, 8, 9]].any()
    # the f64 sum of each row's contributions, rounded once to f32
    exact = np.zeros((11, 3))
    np.add.at(exact, ids.reshape(-1), w.reshape(-1, 3).astype(np.float64))
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


def _count_lookups(monkeypatch):
    calls = []
    orig = T.lookup

    def counting(table, ids):
        calls.append(tuple(ids.shape))
        return orig(table, ids)

    monkeypatch.setattr(T, "lookup", counting)
    return calls


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lookups_per_call(arch, monkeypatch):
    """One lookup per ``jnp.take`` of the reference: on the card each is
    one embedding-bag launch (chip_smoke.py holds the counts there)."""
    m = model(arch)
    cfg, params, b = m["tcfg"], m["port"]["f32"], batch(arch)
    calls = _count_lookups(monkeypatch)
    logits(T, arch, cfg, params, b)
    assert len(calls) == LOOKUPS[(arch, "logits")]
    calls.clear()
    retrieval(T, arch, cfg, params, b, candidates(arch))
    assert len(calls) == LOOKUPS[(arch, "retrieval")]
    calls.clear()
    loss = getattr(T, f"{arch.split('-')[0]}_train_loss")
    loss(cfg, params, {k: torch.as_tensor(v) for k, v in b.items()})
    assert len(calls) == LOOKUPS[(arch, "train")]


# ---------------------------------------------------------------------------
# the entry points against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logits_match_reference(arch, dtype):
    m = model(arch)
    b = batch(arch)
    want = logits(J, arch, m["jcfg"], m["jax"][dtype], b)
    got = logits(T, arch, m["tcfg"], m["port"][dtype], b)
    assert want.dtype == jnp.float32  # promoted where the reference mixes dtypes
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_retrieval_matches_reference(arch, dtype):
    m = model(arch)
    b, cand = batch(arch), candidates(arch)
    want = retrieval(J, arch, m["jcfg"], m["jax"][dtype], b, cand, user=1)
    got = retrieval(T, arch, m["tcfg"], m["port"][dtype], b, cand, user=1)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("cand_field", (1, 3))
@pytest.mark.parametrize("arch", ("fm", "autoint", "dlrm-mlperf"))
def test_retrieval_on_another_field(arch, cand_field):
    m = model(arch)
    b = batch(arch)
    cand = np.arange(m["tcfg"].vocab_sizes[cand_field] - 17, dtype=np.int32)
    x = {J: jnp.asarray, T: torch.as_tensor}
    outs = []
    for pkg, cfg, params in ((J, m["jcfg"], m["jax"]["f32"]), (T, m["tcfg"], m["port"]["f32"])):
        if arch == "dlrm-mlperf":
            outs.append(pkg.dlrm_retrieval(cfg, params, x[pkg](b["dense"][2]),
                                           x[pkg](b["sparse"][2]), x[pkg](cand), cand_field))
        else:
            outs.append(getattr(pkg, f"{arch}_retrieval")(
                cfg, params, x[pkg](b["sparse"][2]), x[pkg](cand), cand_field))
    assert_close(outs[1], outs[0], "f32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_sasrec_encode_with_padding(dtype):
    """Hidden states of sequences that start with padding, and of one that
    is all padding (every query sees no key: a uniform softmax, as the
    reference's -1e30 gives; -inf would give NaN)."""
    m = model("sasrec")
    seq = batch("sasrec")["item_seq"].copy()
    seq[1] = 0
    want = J.sasrec_encode(m["jcfg"], m["jax"][dtype], jnp.asarray(seq))
    got = T.sasrec_encode(m["tcfg"], m["port"][dtype], torch.from_numpy(seq))
    assert np.isfinite(_np(got)).all()
    assert_close(got, want, dtype)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_retrieval_gap_within_the_card_tolerance(arch):
    """Retrieval scores against the batch entry point on the same user
    with each candidate filled in, with bf16 tables: the reference's own
    gap (FM's is the largest, about 3.5e-3 of the largest score, from its
    bf16 sums formed in another grouping) and the port's both lie within
    GAP_REL of the largest score."""
    m = model(arch)
    b, cand = batch(arch), candidates(arch)
    for pkg, cfg, params in ((J, m["jcfg"], m["jax"]), (T, m["tcfg"], m["port"])):
        r = _np(retrieval(pkg, arch, cfg, params["bf16"], b, cand))
        s = _np(logits(pkg, arch, cfg, params["bf16"], filled_in(arch, b, cand)))
        assert float(np.abs(r - s).max()) <= GAP_REL * float(np.abs(s).max()), (pkg.__name__,
                                                                                arch)


def test_dlrm_retrieval_refuses_a_mesh_hint():
    m = model("dlrm-mlperf")
    b = batch("dlrm-mlperf")
    with pytest.raises(NotImplementedError, match="A12.2b"):
        T.dlrm_retrieval(m["tcfg"], m["port"]["f32"], torch.from_numpy(b["dense"][0]),
                         torch.from_numpy(b["sparse"][0]), torch.arange(4, dtype=torch.int32),
                         constrain=lambda x: x)


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_converter_keeps_each_leaf_dtype(arch):
    m = model(arch)
    for dtype in DTYPES:
        jl, tl = jax.tree.leaves(m["jax"][dtype]), flatten(m["port"][dtype])[0]
        assert len(jl) == len(tl)
        for w, g in zip(jl, tl):
            assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name
            if g.dtype == torch.bfloat16:  # bit for bit
                np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                              np.asarray(w).view(np.int16))
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_converter_rejects_other_layouts():
    m = model("dlrm-mlperf")
    tree = jax.tree.map(np.asarray, m["jax"]["f32"])
    cfg = m["tcfg"]
    with pytest.raises(ValueError, match="expected keys"):
        recsys_params_from_numpy(cfg, {k: v for k, v in tree.items() if k != "emb"}, "cpu")
    with pytest.raises(ValueError, match="expected a list of 3"):
        recsys_params_from_numpy(cfg, {**tree, "top_w": tree["top_w"][:2]}, "cpu")
    with pytest.raises(ValueError, match="expected shape"):
        recsys_params_from_numpy(cfg, {**tree, "emb": tree["emb"][:-1]}, "cpu")
    other = dataclasses.replace(cfg, embed_dim=8)
    with pytest.raises(ValueError, match="/emb: expected shape"):
        recsys_params_from_numpy(other, tree, "cpu")
