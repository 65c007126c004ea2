"""ROADMAP C18 repaired: NequIP edge sources outside [0, N).

``tests/test_torch_nequip.py``'s graph (64 nodes, 256 edges, 4 graphs,
seed 3; reduced config) with one extra edge into node 2 whose source is
past the end (64, 69) or negative (-1, -70).  The reference's
``forward_energy`` gathers ``s[src]``: a negative source counts from the
end and the result is clamped into [0, N), so 64 and 69 read node 63, -1
reads node 63 and -70 (-6 from the end) reads node 0.  The port's
``_edge_messages`` reads them the same way (it raised ``IndexError`` on
the CPU before, and would have tripped a device assert on the card).

Tolerance: the energies within 1e-5 of their largest magnitude (the
segment sums' order), as ``tests/test_torch_nequip.py`` holds them.
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
from repro_torch.models import nequip as tnq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, E, G = 64, 256, 4
JCFG, TCFG = jcfgs.reduced_config(), tcfgs.reduced_config()
SOURCES = (64, 69, -1, -70)
#: the node each source reads in the reference's gather
READS = {64: 63, 69: 63, -1: 63, -70: 0}
TOL = 1e-5


def _with_edge(graph, src):
    """The graph with one extra edge src -> 2 of vector (1, 0.5, -0.25)."""
    extra = np.array([[src], [2]], np.int32)
    return dict(graph, edge_index=np.concatenate([graph["edge_index"], extra], axis=1),
                edge_vec=np.concatenate([graph["edge_vec"],
                                         np.array([[1.0, 0.5, -0.25]], np.float32)]))


@pytest.fixture(scope="module")
def world():
    """The graph, both packages' parameters and the reference's energies
    for each extra source and for the node it reads (one program)."""
    graph = jpipe.random_graph(N, E, JCFG.d_feat_in, n_graphs=G, seed=3)
    jp = jax.jit(lambda key: jnq.init_params(JCFG, key))(jax.random.PRNGKey(0))
    tp = nequip_params_from_numpy(TCFG, jax.tree.map(np.asarray, jp), device="cpu")
    srcs = np.array(SOURCES + tuple(READS[s] for s in SOURCES), np.int32)
    base = _with_edge(graph, 0)

    def energies(p, src):
        def one(s):
            ei = jnp.asarray(base["edge_index"]).at[0, E].set(s)
            return jnq.forward_energy(JCFG, p, base["node_feat"], ei, base["edge_vec"],
                                      base["graph_id"], G)
        return jax.vmap(one)(src)

    ref = np.asarray(jax.jit(energies)(jp, srcs))
    return {"graph": graph, "tp": tp, "ref": dict(zip(srcs[:len(SOURCES)].tolist(),
                                                      ref[:len(SOURCES)])),
            "ref_read": ref[len(SOURCES):]}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _port_energy(world, src):
    g = {k: torch.as_tensor(v) for k, v in _with_edge(world["graph"], src).items()}
    return tnq.forward_energy(TCFG, world["tp"], g["node_feat"], g["edge_index"],
                              g["edge_vec"], g["graph_id"], G).numpy()


@pytest.mark.parametrize("src", SOURCES)
def test_out_of_range_source_matches_the_reference(world, src):
    """The port's energies within 1e-5 of the reference's, and equal to
    the port's own with the source the reference reads."""
    got = _port_energy(world, src)
    _close(got, world["ref"][src])
    np.testing.assert_array_equal(got, _port_energy(world, READS[src]))


def test_reference_reads_the_clamped_node(world):
    """The reference's energy at each source is its energy at the node its
    gather reads."""
    for i, src in enumerate(SOURCES):
        _close(world["ref"][src], world["ref_read"][i])
