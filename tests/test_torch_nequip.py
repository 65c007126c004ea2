"""The port's NequIP (``repro_torch.models.nequip``) and graph pipelines
against the reference's, on the CPU at ``reduced_config()`` (2 layers, 8
channels, 4 radial functions, 16 input features): the same numpy-seeded
graph (64 nodes, 256 edges, 4 graphs) and the same parameters, carried
over by ``convert.nequip_params_from_numpy``.  The reference runs once per
module (a module fixture holds its results).

Tolerances.  The radial basis and the harmonics within 4 f32 ulps of
their largest value (each package's own f32 sine at arguments up to
about 25; measured: 2.6 ulps).  Everything past a segment sum within an f32
summation-order tolerance: ``index_add_`` and XLA's scatter add each
receiver's messages in another order, and ``einsum`` contracts in
another order too.  Messages, layer outputs and energies within 1e-5 of
the largest magnitude of their tensor (measured: 2e-7 of it); the loss
within 1e-5 relative; each gradient leaf within 1e-4 in relative
Frobenius norm (measured: under 3e-6).  Pipelines: identical arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import nequip as jcfgs
from repro.data import pipelines as jpipe
from repro.models import nequip as jnq
from repro_torch.configs import nequip as tcfgs
from repro_torch.convert import nequip_params_from_numpy
from repro_torch.data import pipelines as tpipe
from repro_torch.models import nequip as tnq
from repro_torch.train.loop import value_and_grad
from repro_torch.train.tree import flatten


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ULPS = 4
F32_EPS = float(np.finfo(np.float32).eps)
SUM_RTOL = 1e-5
GRAD_RTOL = 1e-4
N, E, G = 64, 256, 4
JCFG, TCFG = jcfgs.reduced_config(), tcfgs.reduced_config()
GRAPH_KEYS = ("node_feat", "edge_index", "edge_vec", "graph_id")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, rtol=SUM_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _node_inputs(seed):
    """Seeded node states (s, v, t) as numpy, t symmetric traceless."""
    rng = np.random.default_rng(seed)
    C = TCFG.channels
    m = rng.standard_normal((N, C, 3, 3)).astype(np.float32)
    m = 0.5 * (m + np.swapaxes(m, -1, -2))
    m -= np.trace(m, axis1=-2, axis2=-1)[..., None, None] * np.eye(3, dtype=np.float32) / 3
    return (rng.standard_normal((N, C)).astype(np.float32),
            rng.standard_normal((N, C, 3)).astype(np.float32), m.astype(np.float32))


def _zero_length(graph):
    """The graph with edge 5 of zero length."""
    vec = graph["edge_vec"].copy()
    vec[5] = 0.0
    return dict(graph, edge_vec=vec)


#: extra edges into node N and node -1 (and one past N)
EXTRA = np.array([[1, 2, 3], [N, -1, N + 5]], np.int32)


def _out_of_range(graph):
    """(the graph with EXTRA edges and node 0 in graph G, the graph with
    node 0 in graph G only): both must give the same energies."""
    gid = graph["graph_id"].copy()
    gid[0] = G
    wide = dict(graph, graph_id=gid,
                edge_index=np.concatenate([graph["edge_index"], EXTRA], axis=1),
                edge_vec=np.concatenate([graph["edge_vec"], np.ones((3, 3), np.float32)]))
    return wide, dict(graph, graph_id=gid)


def _reference(jp, g, s, v, t, zero, wide, narrow):
    """Every result of the reference the tests compare with, as one
    program (one compile)."""
    energy = lambda graph, **kw: jnq.forward_energy(  # noqa: E731
        JCFG, jp, *(graph[k] for k in GRAPH_KEYS), G, **kw)
    r, u, y2 = jnq.edge_harmonics(g["edge_vec"])
    lp = jp["layers"][0]
    ref = {"edge_messages": jnq._edge_messages(JCFG, lp, s, v, t, g["edge_index"][0],
                                               g["edge_index"][1], r, u, y2, N),
           "wide": energy(wide), "narrow": energy(narrow)}
    for chunks in (1, 2):
        ref[f"layer{chunks}"] = jnq._message_layer(JCFG, lp, s, v, t, g["edge_index"], r, u,
                                                   y2, N, n_edge_chunks=chunks)
        ref[f"energy{chunks}"] = energy(g, n_edge_chunks=chunks)
    ref["loss"], ref["grads"] = jax.value_and_grad(
        lambda p: jnq.forward_train(JCFG, p, g, G))(jp)
    ref["zero_loss"], ref["zero_grad"] = jax.value_and_grad(
        lambda vec: jnq.forward_train(JCFG, jp, dict(zero, edge_vec=vec), G))(zero["edge_vec"])
    return ref


@pytest.fixture(scope="module")
def world():
    """The graph, both packages' parameters and every reference result the
    tests compare with."""
    graph = jpipe.random_graph(N, E, JCFG.d_feat_in, n_graphs=G, seed=3)
    jp = jax.jit(lambda key: jnq.init_params(JCFG, key))(jax.random.PRNGKey(0))
    tp = nequip_params_from_numpy(TCFG, _np_tree(jp), device="cpu")
    ref = jax.jit(_reference)(jp, _j(graph), *(jnp.asarray(x) for x in _node_inputs(7)),
                              _j(_zero_length(graph)), *(_j(x) for x in _out_of_range(graph)))
    return {"graph": graph, "jp": jp, "tp": tp, "ref": jax.tree.map(np.asarray, ref)}


def test_params_layout_and_conversion(world):
    want = jax.tree.leaves(jnq.abstract_params(JCFG))
    for params in (tnq.abstract_params(TCFG), world["tp"],
                   tnq.init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")):
        got = flatten(params)[0]
        assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want]
        assert all(x.dtype == torch.float32 for x in got)
    for a, b in zip(flatten(world["tp"])[0], jax.tree.leaves(world["jp"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the gates share their draws with the scalar mixes, as the reference's keys
    p = tnq.init_params(tcfgs.config(), torch.Generator().manual_seed(1), device="cpu")
    lp = p["layers"][0]
    torch.testing.assert_close(lp["gate_v"], lp["mix_s_self"] * (0.1 * 32 ** 0.5))
    torch.testing.assert_close(lp["gate_t"], lp["mix_s_msg"] * (0.1 * 32 ** 0.5))
    with pytest.raises(ValueError, match="expected shape"):
        bad = _np_tree(world["jp"])
        bad["embed_in"] = bad["embed_in"][:-1]
        nequip_params_from_numpy(TCFG, bad, device="cpu")


def test_entry_points_default_to_the_card(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tnq.init_params(TCFG, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        nequip_params_from_numpy(TCFG, _np_tree(world["jp"]))


def test_bessel_rbf_and_harmonics():
    rng = np.random.default_rng(0)
    vec = (rng.standard_normal((200, 3)) * 3).astype(np.float32)
    vec[:3] = [[0, 0, 0], [1e-10, 0, 0], [6.0, 0, 0]]   # zero, under EPS, past the cutoff
    r = np.linalg.norm(vec, axis=-1).astype(np.float32)
    got = tnq.bessel_rbf(torch.as_tensor(r), TCFG.n_rbf, TCFG.cutoff).numpy()
    m = rng.standard_normal((5, 3, 3)).astype(np.float32)
    want_rbf, want_harm, want_sym = jax.jit(lambda r, vec, m: (
        jnq.bessel_rbf(r, JCFG.n_rbf, JCFG.cutoff), jnq.edge_harmonics(vec),
        jnq._sym_traceless(m)))(r, vec, m)
    _close(got, want_rbf, ULPS * F32_EPS)
    for g, w in zip(tnq.edge_harmonics(torch.as_tensor(vec)), want_harm):
        _close(g.numpy(), np.asarray(w), ULPS * F32_EPS)
    _close(tnq._sym_traceless(torch.as_tensor(m)).numpy(), want_sym, ULPS * F32_EPS)


def test_edge_messages(world):
    g = _t(world["graph"])
    r, u, y2 = tnq.edge_harmonics(g["edge_vec"])
    s, v, t = (torch.as_tensor(x) for x in _node_inputs(7))
    got = tnq._edge_messages(TCFG, world["tp"]["layers"][0], s, v, t, g["edge_index"][0],
                             g["edge_index"][1], r, u, y2, N)
    for a, b in zip(got, world["ref"]["edge_messages"]):
        _close(a.numpy(), b)


@pytest.mark.parametrize("chunks", [1, 2])
def test_message_layer(world, chunks):
    g = _t(world["graph"])
    r, u, y2 = tnq.edge_harmonics(g["edge_vec"])
    s, v, t = (torch.as_tensor(x) for x in _node_inputs(7))
    got = tnq._message_layer(TCFG, world["tp"]["layers"][0], s, v, t, g["edge_index"], r, u,
                             y2, N, n_edge_chunks=chunks)
    for a, b in zip(got, world["ref"][f"layer{chunks}"]):
        _close(a.numpy(), b)


@pytest.mark.parametrize("chunks", [1, 2])
def test_forward_energy(world, chunks):
    g = _t(world["graph"])
    got = tnq.forward_energy(TCFG, world["tp"], *(g[k] for k in GRAPH_KEYS), G,
                             n_edge_chunks=chunks)
    assert got.shape == (G,) and got.dtype == torch.float32
    _close(got.numpy(), world["ref"][f"energy{chunks}"])


def test_forward_train_loss_and_gradients(world):
    batch = _t(world["graph"])
    loss, grads = value_and_grad(lambda p, b: tnq.forward_train(TCFG, p, b, G), world["tp"],
                                 batch)
    np.testing.assert_allclose(float(loss), float(world["ref"]["loss"]), rtol=SUM_RTOL)
    got, _ = flatten(grads)
    want = jax.tree.leaves(world["ref"]["grads"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float64)
        err = np.linalg.norm(a.numpy().astype(np.float64) - b)
        assert err <= GRAD_RTOL * max(np.linalg.norm(b), 1e-30), (err, np.linalg.norm(b))


@pytest.mark.parametrize("seed", [0, 5])
def test_graph_pipelines_match_the_reference(seed):
    got = tpipe.random_graph(300, 900, 7, n_graphs=3, seed=seed)
    want = jpipe.random_graph(300, 900, 7, n_graphs=3, seed=seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # a node with no in-edge, so that the sampler draws self-loops
    ei = got["edge_index"][:, got["edge_index"][1] != 4]
    csr, jcsr = tpipe.build_csr(300, ei), jpipe.build_csr(300, ei)
    for a, b in zip(csr, jcsr):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    seeds = np.array([4, 17, 250, 3])
    for a, b in zip(tpipe.neighbor_sample(*csr, seeds, seed=seed),
                    jpipe.neighbor_sample(*jcsr, seeds, seed=seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _random_rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def test_rotation_invariance_and_equivariance(world):
    g = _t(world["graph"])
    R = torch.as_tensor(_random_rotation(11))
    args = (TCFG, world["tp"], g["node_feat"], g["edge_index"])
    s, v, t = tnq._node_states(*args, g["edge_vec"])
    s_r, v_r, t_r = tnq._node_states(*args, g["edge_vec"] @ R.T)
    _close(s_r.numpy(), s.numpy())
    _close(v_r.numpy(), (v @ R.T).numpy())          # l = 1 rotates with the edges
    _close(t_r.numpy(), (R @ t @ R.T).numpy())      # l = 2 as R t R^T
    e = tnq.forward_energy(TCFG, world["tp"], *(g[k] for k in GRAPH_KEYS), G)
    e_r = tnq.forward_energy(TCFG, world["tp"], g["node_feat"], g["edge_index"],
                             g["edge_vec"] @ R.T, g["graph_id"], G)
    _close(e_r.numpy(), e.numpy())


def test_out_of_range_ids_are_dropped_as_segment_sum_drops_them(world):
    """C13: an id outside [0, n) -- past the end or negative -- adds
    nothing, in ``jax.ops.segment_sum`` and in the port's ``index_add_``
    (where a raw ``index_add_`` raises on the CPU and asserts on the
    card)."""
    ids = np.array([0, 3, -1, 2, 5, -7], np.int32)
    data = np.arange(1, 7, dtype=np.float32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=3))
    np.testing.assert_array_equal(want, [1, 0, 4])
    got = tnq._segment_sum(torch.as_tensor(data), torch.as_tensor(ids), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(IndexError):
        torch.zeros(3).index_add_(0, torch.as_tensor(ids), torch.as_tensor(data))
    # extra edges into node N and node -1, and node 0 in graph G
    wide, narrow = _out_of_range(world["graph"])
    tw = tnq.forward_energy(TCFG, world["tp"], *(torch.as_tensor(wide[k]) for k in GRAPH_KEYS),
                            G)
    tn = tnq.forward_energy(TCFG, world["tp"],
                            *(torch.as_tensor(narrow[k]) for k in GRAPH_KEYS), G)
    _close(world["ref"]["wide"], world["ref"]["narrow"])
    _close(tw.numpy(), tn.numpy())
    _close(tw.numpy(), world["ref"]["wide"])


def test_chunks_that_do_not_divide_the_edges_raise(world):
    """C14: 256 edges in 3 chunks.  The reference fails an ``assert``
    (nothing under ``python -O``); the port raises ``ValueError``."""
    g = _t(world["graph"])
    with pytest.raises(ValueError, match="256 edges do not split into 3"):
        tnq.forward_energy(TCFG, world["tp"], *(g[k] for k in GRAPH_KEYS), G, n_edge_chunks=3)
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda *a: jnq.forward_energy(JCFG, world["jp"], *a, G, n_edge_chunks=3),
                       *(jnp.asarray(world["graph"][k]) for k in GRAPH_KEYS))


def test_zero_length_edge_pinned(world):
    """C15: a zero-length edge (the sampler's self-loops) gives a finite
    forward in both packages (u = 0, Y2 = -I/3, the basis at EPS).  The
    gradient with respect to the edge vectors is NaN in the reference
    (``jnp.linalg.norm``'s at 0) and finite in the port
    (``torch.linalg.norm``'s is 0 there)."""
    jl, jgrad = world["ref"]["zero_loss"], world["ref"]["zero_grad"]
    assert np.isfinite(jl)
    assert np.isnan(jgrad[5]).all()
    tb = _t(_zero_length(world["graph"]))
    vec = tb["edge_vec"].clone().requires_grad_(True)
    tl = tnq.forward_train(TCFG, world["tp"], dict(tb, edge_vec=vec), G)
    (tgrad,) = torch.autograd.grad(tl, vec)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=SUM_RTOL)
    assert torch.isfinite(tgrad).all()
    # away from the zero-length edge the gradients agree
    keep = np.arange(E) != 5
    _close(tgrad.numpy()[keep], jgrad[keep], GRAD_RTOL)
