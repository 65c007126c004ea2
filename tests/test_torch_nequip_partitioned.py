"""NequIP's partitioned step over ``torch.distributed`` ranks
(``models.nequip.partitioned_train_step_fn``, ``build_partition``,
``dist.step``) against the reference's on the CPU.

The reference runs once per module in a subprocess with 4 host devices: its
``build_partition`` on the graphs below (4 blocks, and 2 and 8 for the
arrays alone), and its ``partitioned_train_step_fn``'s loss and
``jax.grad`` on ``tests/test_dist.py``'s graph (32 nodes, 96 edges, 2
graphs) over a (2, 2) mesh, jitted once.  The port's 4 ranks run over gloo
on the CPU from the same numpy-seeded weights.

Tolerances (f32): the loss within 1e-5 relative; every gradient leaf
within 1e-5 of the leaf's largest magnitude (the halo's sums, the scatter's
order and the sum over ranks); ``build_partition``'s arrays equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.nequip import config as nq_config
from repro_torch.data.pipelines import random_graph
from repro_torch.dist.sharding import P, local_shard
from repro_torch.dist.step import partitioned_train_step, partitioned_value_and_grad
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import nequip
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.tree import flatten, unflatten


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
CFG = nequip.NequIPConfig(d_feat_in=6, channels=4, n_layers=2, n_rbf=4)
G = 2
#: graph name -> (nodes, edges, seed); "dist" is tests/test_dist.py's
GRAPHS = {"dist": (32, 96, 0), "wide": (256, 1024, 3)}
ARRAYS = ("node_feat", "edge_src", "edge_dst", "edge_vec", "export_idx", "graph_id")
TOL = 1e-5

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.models import nequip

inp = np.load(sys.argv[1])
cfg = nequip.NequIPConfig(d_feat_in=6, channels=4, n_layers=2, n_rbf=4)
treedef = jax.tree.structure(nequip.init_params(cfg, jax.random.PRNGKey(0)))
params = jax.tree.unflatten(treedef, [jnp.asarray(inp[f"p{i}"])
                                      for i in range(treedef.num_leaves)])
out = {}
for name in ("dist", "wide"):
    for ndev in (2, 4, 8):
        part = nequip.build_partition(inp[f"{name}_feat"], inp[f"{name}_ei"],
                                      inp[f"{name}_ev"], inp[f"{name}_gid"], ndev=ndev)
        for k, v in part.items():
            out[f"{name}_{ndev}_{k}"] = v
part = {k[len("dist_4_"):]: jnp.asarray(v) for k, v in out.items() if k.startswith("dist_4_")}
part["energy"] = jnp.asarray(inp["energy"])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
loss_fn = nequip.partitioned_train_step_fn(cfg, mesh, ("data", "model"), 2)
with mesh:
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params, part)
out["loss"] = loss
for j, leaf in enumerate(jax.tree.leaves(g)):
    out[f"g{j}"] = leaf
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("REF_OK")
"""


def _graph(name):
    N, E, seed = GRAPHS[name]
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((N, 6)).astype(np.float32)
    ei = rng.integers(0, N, (2, E)).astype(np.int32)
    ev = (rng.standard_normal((E, 3)) * 2).astype(np.float32)
    gid = np.sort(rng.integers(0, G, N)).astype(np.int32)
    return feat, ei, ev, gid


def _inputs():
    rng = np.random.default_rng(11)
    params = nequip.init_params(CFG, None, device="meta")
    leaves = [(rng.standard_normal(tuple(x.shape)) * 0.5).astype(np.float32)
              for x in flatten(params)[0]]
    energy = rng.standard_normal(G).astype(np.float32)
    return leaves, energy


def _params(leaves):
    return unflatten(nequip.init_params(CFG, None, device="meta"),
                     [torch.from_numpy(x) for x in leaves])


def _rank(mesh, path):
    """One rank's loss, summed gradient and AdamW step; the inputs are read
    from ``path`` (numpy arrays passed as spawn arguments reach the ranks
    slowly)."""
    inp = np.load(path)
    leaves = [inp[f"p{i}"] for i in range(sum(k[1:].isdigit() for k in inp.files))]
    part, energy = {k: inp[f"part_{k}"] for k in ARRAYS}, inp["energy"]
    coords = dict(zip(AXES, mesh.coords))
    batch = {k: local_shard(torch.from_numpy(part[k]), P(AXES), mesh.shape, coords)
             for k in ARRAYS}
    batch["energy"] = torch.from_numpy(energy)
    params = _params(leaves)
    loss_fn = nequip.partitioned_train_step_fn(CFG, mesh, G)
    loss, grads = partitioned_value_and_grad(loss_fn, mesh, params, batch)
    opt = AdamWConfig()
    stepped, _, loss2 = partitioned_train_step(loss_fn, mesh, opt)(params, adamw_init(params),
                                                                   batch)
    out = {"loss": float(loss), "loss2": float(loss2), "grads": flatten(grads)[0],
           "stepped": flatten(stepped)[0], "traffic": dict(mesh.traffic)}
    # the registry's minibatch_lg cell on this rank mesh: the partitioned
    # layout and step, on a small graph of the cell's feature width
    cell = treg.build_cell("nequip", "minibatch_lg", mesh=mesh)
    g = random_graph(256, 512, 602, seed=5)
    g["edge_index"][1] = np.arange(512) % 256  # 128 edges a block: 4 chunks divide them
    part = nequip.build_partition(g["node_feat"], g["edge_index"], g["edge_vec"],
                                  g["graph_id"], mesh.size)
    cb = {k: local_shard(torch.from_numpy(v), P(AXES), mesh.shape, coords)
          for k, v in part.items()}
    cb["energy"] = torch.from_numpy(g["energy"])
    cp = nequip.init_params(nq_config(d_feat_in=602), torch.Generator().manual_seed(0), "cpu")
    _, opt_state, cell_loss = cell.step_fn(cp, adamw_init(cp), cb)
    out.update(cell_loss=float(cell_loss), cell_step=int(opt_state["step"]),
               cell_keys=sorted(cell.abstract_args[2]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("nq")
    leaves, energy = _inputs()
    graphs = {}
    for name in GRAPHS:
        feat, ei, ev, gid = _graph(name)
        graphs.update({f"{name}_feat": feat, f"{name}_ei": ei, f"{name}_ev": ev,
                       f"{name}_gid": gid})
    part = nequip.build_partition(*_graph("dist"), ndev=4)
    np.savez(d / "in.npz", energy=energy, **graphs, **{f"part_{k}": v for k, v in part.items()},
             **{f"p{i}": x for i, x in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _REF, str(d / "in.npz"), str(d / "ref.npz")],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = spawn_ranks(_rank, (2, 2), "gloo", "cpu", args=(str(d / "in.npz"),), axes=AXES,
                           timeout_s=300)
    finally:
        out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0 and "REF_OK" in out, err[-3000:]
    return leaves, energy, dict(np.load(d / "ref.npz")), port


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_build_partition_matches_the_reference(runs, name, ndev):
    ref = runs[2]
    got = nequip.build_partition(*_graph(name), ndev=ndev)
    assert set(got) == set(ARRAYS)
    for k in ARRAYS:
        want = ref[f"{name}_{ndev}_{k}"]
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want), k


def test_build_partition_refuses_unequal_blocks():
    feat, ei, ev, gid = _graph("dist")
    with pytest.raises(ValueError, match="equal blocks"):
        nequip.build_partition(feat, ei, ev, gid, ndev=3)


def test_partitioned_loss_matches_the_reference(runs):
    _, _, ref, port = runs
    want = float(ref["loss"])
    for r in port:
        assert abs(r["loss"] - want) <= TOL * abs(want)
        assert r["loss2"] == r["loss"]


def test_partitioned_gradient_matches_the_reference(runs):
    _, _, ref, port = runs
    for r in port:  # the summed gradient is every rank's
        for j, g in enumerate(r["grads"]):
            _close(g, ref[f"g{j}"])


def test_partitioned_gradient_is_the_dense_one(runs):
    """The summed gradient equals the dense step's on the same graph, and
    one AdamW step on every rank equals the dense step's update."""
    leaves, energy, _, port = runs
    feat, ei, ev, gid = _graph("dist")
    batch = {"node_feat": torch.from_numpy(feat), "edge_index": torch.from_numpy(ei),
             "edge_vec": torch.from_numpy(ev), "graph_id": torch.from_numpy(gid),
             "energy": torch.from_numpy(energy)}
    params = _params(leaves)
    loss, grads = value_and_grad(lambda p, b: nequip.forward_train(CFG, p, b, G), params, batch)
    assert abs(port[0]["loss"] - float(loss)) <= TOL * abs(float(loss))
    for got, want in zip(port[0]["grads"], flatten(grads)[0]):
        _close(got, want)
    stepped, _ = adamw_update(AdamWConfig(), params, grads, adamw_init(params))
    for got, want in zip(port[0]["stepped"], flatten(stepped)[0]):
        _close(got, want, 1e-6)


def test_registry_cell_steps_partitioned_on_the_rank_mesh(runs):
    """``build_cell("nequip", "minibatch_lg")`` on a rank mesh of 4 takes
    the partitioned layout and step: one AdamW step, the same finite loss
    on every rank."""
    port = runs[3]
    assert all(np.isfinite(r["cell_loss"]) and r["cell_loss"] == port[0]["cell_loss"]
               and r["cell_step"] == 1 for r in port)
    assert port[0]["cell_keys"] == sorted(ARRAYS + ("energy",))


def test_halo_bytes(runs):
    """Layer 0 exchanges s alone, every later layer s, v and t: the
    forward's all-gathers move (n-1) x |export block| x C x (1 + 4 x 13)
    floats a rank (2 layers), the backward's reduce-scatters as much
    again."""
    port = runs[3]
    part = nequip.build_partition(*_graph("dist"), ndev=4)
    xmax = part["export_idx"].shape[0] // 4
    assert nequip.halo_bytes_per_layer(4, xmax, CFG.channels) == 4 * xmax * 4 * 13 * 4
    tr = port[0]["traffic"]
    assert tr["bytes"] > 3 * xmax * CFG.channels * (1 + 13) * 4
