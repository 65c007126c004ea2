"""Expert-parallel MoE training over ``torch.distributed`` ranks
(``models.transformer._moe_ffn_ep``, ``dist.step``, ``launch.mesh``)
against the reference's ``_moe_ffn_ep`` on the CPU.

The reference runs once per module in a subprocess with 4 host devices
(``--xla_force_host_platform_device_count=4``) on meshes whose axes are
``Auto``: with ``jax.make_mesh``'s default ``Explicit`` axes JAX 0.9
refuses the reference's ``with_sharding_constraint`` in ``_gqa_attention``
(ROADMAP C16, checked here too).  One jitted program a mesh computes every
case: ``_moe_ffn_ep`` on layer 0's normed input, then the loss and
``jax.grad`` of ``forward_train`` with ``ep_mesh``, on (2, 2) with
``ep_fsdp`` off and on at capacity factors 4.0 (no drop) and 1.0 (each
data shard drops tokens of its own), and on (1, 4) (one expert a rank).
The port's ranks run the same cases at once, 4 processes over gloo on the
CPU (``spawn_ranks``), from the same numpy-seeded weights and tokens.

Tolerances (f32 throughout): y, the loss and every gradient leaf within
1e-5 of the largest magnitude of the reference's value (summation order
of the products, of the exchange's blocks and of the gradients' sums over
ranks); aux within 1e-6 (a mean of a few f32 products).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.dist.collectives import all_gather, all_to_all, psum
from repro_torch.dist.sharding import P, from_shards, local_shard
from repro_torch.dist.step import ep_param_specs, ep_train_step, ep_value_and_grad, shard_tree
from repro_torch.launch.mesh import Mesh, init_rank_mesh, spawn_ranks
from repro_torch.models import transformer as tf
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
#: (mesh shape, ep_fsdp, capacity factor)
CASES = [((2, 2), False, 4.0), ((2, 2), True, 4.0), ((2, 2), False, 1.0),
         ((2, 2), True, 1.0), ((1, 4), False, 4.0)]
IDS = [f"{s[0]}x{s[1]}-{'fsdp' if f else 'ep'}-cf{cf}" for s, f, cf in CASES]
B, S = 4, 16
TOL = 1e-5

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.models import transformer as tf
from repro.models.common import rms_norm

inp = np.load(sys.argv[1])
cases = eval(sys.argv[3])  # {global index: (mesh shape, ep_fsdp, capacity factor)}
cfg0 = tf.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                   vocab=64, moe=tf.MoEConfig(n_experts=4),
                   param_dtype=jnp.float32, act_dtype=jnp.float32)
treedef = jax.tree.structure(tf.init_params(cfg0, jax.random.PRNGKey(0)))
params = jax.tree.unflatten(treedef, [jnp.asarray(inp[f"p{i}"])
                                      for i in range(treedef.num_leaves)])
tokens = jnp.asarray(inp["tokens"])
h0 = jnp.asarray(inp["h0"])
out = {}
# ROADMAP C16: jax.make_mesh's default (Explicit) axes refuse the reference's
# with_sharding_constraint while it traces
try:
    if sys.argv[4] != "explicit":
        raise LookupError("not this process's")
    em = jax.make_mesh((2, 2), ("data", "model"))
    cfgx = dataclasses.replace(cfg0, ep_mesh=em, ep_dp_axes=("data",))
    with em:
        jax.jit(lambda p, t: tf.forward_train(cfgx, p, t, t)).trace(params, tokens)
    out["explicit_error"] = np.array("")
except LookupError:
    pass
except Exception as e:  # noqa: BLE001 - the refusal is the observation
    out["explicit_error"] = np.array(f"{type(e).__name__}: {e}"[:400])
for shape in sorted({c[0] for c in cases.values()}):
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    mine = [(i, c) for i, c in cases.items() if c[0] == shape]

    def run(p, tok, h):
        res = []
        for i, (_, fsdp, cf) in mine:
            cfg = dataclasses.replace(cfg0, moe=tf.MoEConfig(n_experts=4, capacity_factor=cf),
                                      ep_mesh=mesh, ep_dp_axes=("data",), ep_fsdp=fsdp)
            p0 = jax.tree.map(lambda a: a[0], p["blocks"]["pos0"])
            y, aux = tf._moe_ffn_ep(cfg, p0, h)
            loss, g = jax.value_and_grad(lambda q: tf.forward_train(cfg, q, tok, tok))(p)
            res.append((y, aux, loss, g))
        return res

    with mesh:
        res = jax.jit(run)(params, tokens, h0)
    for (i, _), (y, aux, loss, g) in zip(mine, res):
        out[f"c{i}_y"], out[f"c{i}_aux"], out[f"c{i}_loss"] = y, aux, loss
        for j, leaf in enumerate(jax.tree.leaves(g)):
            out[f"c{i}_g{j}"] = leaf
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("REF_OK")
"""


def _cfg(cf=1.25):
    return tf.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                       vocab=64, moe=tf.MoEConfig(n_experts=4, capacity_factor=cf),
                       param_dtype=torch.float32, act_dtype=torch.float32)


def _inputs():
    rng = np.random.default_rng(7)
    shapes, paths = flatten(tf.param_shapes(_cfg()))
    leaves = [np.ones(s, np.float32) if p[-1].endswith("norm")
              else (rng.standard_normal(s) * 0.3).astype(np.float32)
              for s, p in zip(shapes, paths)]
    tokens = rng.integers(0, 64, (B, S)).astype(np.int32)
    h0 = rng.standard_normal((B, S, 32)).astype(np.float32)
    return leaves, tokens, h0


def _load(path):
    inp = np.load(path)
    leaves = [inp[f"p{i}"] for i in range(len(inp.files) - 2)]
    return leaves, inp["tokens"], inp["h0"]


def _port_rank(mesh, path, cases):
    """Every case on this rank (y block, aux, loss, gradient blocks, one
    AdamW step's parameter blocks), then the registry's reduced Scout cell's
    step and the collectives' checks.  The inputs are read from ``path``
    (numpy arrays passed as spawn arguments reach the ranks slowly)."""
    leaves, tokens, h0 = _load(path)
    out = []
    meshes = {mesh.mesh.sizes: mesh}
    for shape, fsdp, cf in cases:
        rm = meshes.get(shape) or meshes.setdefault(shape, init_rank_mesh(shape, AXES, "gloo",
                                                                         "cpu"))
        cfg = dataclasses.replace(_cfg(cf), ep_mesh=rm, ep_dp_axes=("data",), ep_fsdp=fsdp)
        full = unflatten(tf.param_shapes(cfg), [torch.from_numpy(x) for x in leaves])
        params = shard_tree(full, ep_param_specs(full, rm, fsdp), rm)
        coords = dict(zip(AXES, rm.coords))
        batch = {k: local_shard(torch.from_numpy(tokens), P("data", None), rm.shape, coords)
                 for k in ("tokens", "labels")}
        h = local_shard(torch.from_numpy(h0), P("data"), rm.shape, coords)
        p0 = {k: v[0] for k, v in params["blocks"]["pos0"].items()}
        y, aux = tf._moe_ffn_ep(cfg, p0, h)
        loss, grads = ep_value_and_grad(cfg, params, batch)
        out.append({"y": y.detach(), "aux": float(aux), "loss": float(loss),
                    "grads": flatten(grads)[0]})
        if cf == 4.0 and shape == (2, 2):
            opt = AdamWConfig()
            stepped = ep_train_step(cfg, opt)(params, adamw_init(params, opt), batch)[0]
            out[-1]["stepped"] = flatten(stepped)[0]
    # the registry's reduced Scout train cell built on this rank mesh takes
    # its expert-parallel step on the rank's blocks
    cell = treg.build_cell("llama4-scout-17b-a16e", "train_4k", reduced=True, mesh=mesh)
    cfg = treg.get_arch_module(cell.arch).reduced_config()
    full = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = shard_tree(full, cell.in_specs[0], mesh)
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (4, 64)))
    tok = local_shard(tok, P("data", None), mesh.shape, dict(zip(AXES, mesh.coords)))
    new, opt_state, loss = cell.step_fn(params, shard_tree(adamw_init(full), cell.in_specs[1],
                                                           mesh),
                                        {"tokens": tok, "labels": tok})
    return {"cases": out, "coll": _collective_rank(mesh),
            "cell": {"cell_loss": float(loss), "cell_step": int(opt_state["step"]),
                     "cell_shapes": [tuple(x.shape) for x in flatten(new)[0]],
                     "cell_moved": any(not torch.equal(a, b) for a, b in
                                       zip(flatten(new)[0], flatten(params)[0]))}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    leaves, tokens, h0 = _inputs()
    np.savez(d / "in.npz", tokens=tokens, h0=h0, **{f"p{i}": x for i, x in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    # the reference's cases in two processes at once (its compiles are most
    # of this module's time), the port's ranks beside them
    halves = {"explicit": [0, 2, 4], "auto": [1, 3]}
    refs = {k: subprocess.Popen(
        [sys.executable, "-c", _REF, str(d / "in.npz"), str(d / f"ref_{k}.npz"),
         repr({i: CASES[i] for i in idx}), k], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, idx in halves.items()}
    try:
        port = spawn_ranks(_port_rank, (2, 2), "gloo", "cpu", args=(str(d / "in.npz"), CASES),
                           axes=AXES, timeout_s=300)
    finally:
        done = {k: p.communicate(timeout=600) for k, p in refs.items()}
    ref = {}
    for k, p in refs.items():
        assert p.returncode == 0 and "REF_OK" in done[k][0], done[k][1][-3000:]
        ref.update(np.load(d / f"ref_{k}.npz"))
    return leaves, tokens, ref, port


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _assembled(port, i, key):
    """Case i's tree ``key`` put back together from the ranks' blocks."""
    shape, fsdp, _ = CASES[i]
    mesh = Mesh(AXES, shape)
    like = tf.param_shapes(_cfg())
    specs = flatten(ep_param_specs(like, mesh, fsdp))[0]
    per_rank = [r["cases"][i][key] for r in port[:mesh.size]]
    return [from_shards([pr[j] for pr in per_rank], spec, mesh) for j, spec in enumerate(specs)]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_moe_ffn_ep_matches_the_reference(runs, i):
    _, _, ref, port = runs
    mesh = Mesh(AXES, CASES[i][0])
    y = from_shards([r["cases"][i]["y"] for r in port[:mesh.size]], P("data"), mesh)
    _close(y, ref[f"c{i}_y"])
    for r in port:
        assert abs(r["cases"][i]["aux"] - float(ref[f"c{i}_aux"])) <= 1e-6


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_ep_loss_and_gradient_match_the_reference(runs, i):
    _, _, ref, port = runs
    loss = float(ref[f"c{i}_loss"])
    for r in port:
        assert abs(r["cases"][i]["loss"] - loss) <= TOL * abs(loss)
    grads = _assembled(port, i, "grads")
    for j, g in enumerate(grads):
        _close(g, ref[f"c{i}_g{j}"])


def test_capacity_one_drops_tokens_locally():
    """At capacity factor 1.0 a data shard's routing drops tokens of its own:
    the local capacity is the shard's (T_loc / E), not the batch's."""
    leaves, tokens, h0 = _inputs()
    cfg = _cfg(1.0)
    full = unflatten(tf.param_shapes(cfg), [torch.from_numpy(x) for x in leaves])
    router = full["blocks"]["pos0"]["router"][0]
    for d in range(2):
        xf = torch.from_numpy(h0[2 * d:2 * d + 2]).reshape(-1, 32)
        r = tf._route(cfg, router, xf, tf.moe_capacity(cfg, xf.shape[0], 1.0))
        assert not bool(r.keep.all())


def test_ep_step_matches_a_global_adamw_step(runs):
    """One AdamW step on the ranks' blocks, put back together, equals the
    step on the whole tree with the ranks' gradient put back together
    (clipping by the norm summed over the ranks that split each leaf)."""
    leaves, _, _, port = runs
    for i in (0, 1):
        full = unflatten(tf.param_shapes(_cfg()), [torch.from_numpy(x) for x in leaves])
        grads = unflatten(full, _assembled(port, i, "grads"))
        want, _ = adamw_update(AdamWConfig(), full, grads, adamw_init(full))
        for got, w in zip(_assembled(port, i, "stepped"), flatten(want)[0]):
            _close(got, w, 1e-6)


def test_ep_gradient_is_the_gradient_of_the_mean_of_shard_losses(runs):
    """With no token dropped, the expert-parallel loss is the mean over the
    data shards of ``forward_train`` on each shard with the local dispatch
    (each shard's auxiliary loss its own routing's).  The port's gradient
    (put back together from the ranks) is that function's gradient, and on
    the router it is not the whole batch's: the batch's auxiliary loss is
    another function of the routing."""
    leaves, tokens, _, port = runs
    cfg = _cfg(4.0)
    params = unflatten(tf.param_shapes(cfg), [torch.from_numpy(x) for x in leaves])
    tok = torch.from_numpy(tokens)

    def mean_loss(p, _):
        return sum(tf.forward_train(cfg, p, tok[2 * d:2 * d + 2], tok[2 * d:2 * d + 2])
                   for d in range(2)) / 2

    loss, g = value_and_grad(mean_loss, params, None)
    _, whole = value_and_grad(lambda p, _: tf.forward_train(cfg, p, tok, tok), params, None)
    assert abs(float(loss) - port[0]["cases"][0]["loss"]) <= TOL * float(loss)
    _, paths = flatten(params)
    for got, want, batch, path in zip(_assembled(port, 0, "grads"), flatten(g)[0],
                                      flatten(whole)[0], paths):
        _close(got, want)
        if path[-1] == "router":
            assert (got - batch).abs().max() > 1e-3 * want.abs().max()


def test_reference_ep_needs_auto_axes(runs):
    """ROADMAP C16: the reference's expert-parallel ``forward_train`` does
    not trace on ``jax.make_mesh``'s default mesh, whose axes are Explicit
    under JAX 0.9 (``tests/test_dist.py::test_shard_map_moe_matches_local_
    dispatch`` fails so); on Auto axes it runs (the cases above)."""
    err = str(runs[2]["explicit_error"])
    assert "Auto" in err and "sharding" in err, err


def test_registry_train_cell_steps_on_the_rank_mesh(runs):
    """``build_cell`` on a rank mesh of 4 gives the registry's layout, its
    experts split over ``model`` (``dist.step.tp_train_step`` around
    ``_moe_ffn_ep``): one AdamW step on every rank's blocks by the cell's
    ``in_specs`` (2 of the 4 experts a layer), the same finite loss
    everywhere."""
    port = runs[3]
    got = [r["cell"] for r in port]
    assert all(np.isfinite(g["cell_loss"]) and g["cell_loss"] == got[0]["cell_loss"]
               for g in got)
    assert all(g["cell_step"] == 1 and g["cell_moved"] for g in got)
    assert (2, 2, 64, 128) in got[0]["cell_shapes"]


def test_require_ported_takes_an_ep_mesh():
    cfg = dataclasses.replace(_cfg(), ep_mesh=Mesh(AXES, (2, 2)), ep_dp_axes=("data",))
    assert tf.param_shapes(cfg)["blocks"]["pos0"]["we_gate"] == (2, 4, 32, 64)


def _collective_rank(mesh):
    mesh.reset_traffic()
    r = mesh.rank
    x = torch.arange(4 * 3, dtype=torch.bfloat16).reshape(4, 3) + 10 * r
    x.requires_grad_(True)
    y = all_to_all(x, mesh, "model")
    g = all_gather(x, mesh, "data", 1)
    s = psum(x.sum(), mesh, "all")
    (y.float().sum() * (r + 1) + g.float().pow(2).sum() + s.float()).backward()
    return {"y": y.detach(), "g": g.detach(), "s": float(s), "grad": x.grad,
            "traffic": dict(mesh.traffic)}


def test_collectives_and_their_backward(runs):
    """all_to_all moves block j to rank j (bf16 as its bytes); all_gather
    concatenates in rank order; their backward passes are the transposes
    (the exchange again; a reduce-scatter); psum passes its cotangent on."""
    res = [r["coll"] for r in runs[3]]
    mesh = Mesh(AXES, (2, 2))
    xs = [torch.arange(12, dtype=torch.float32).reshape(4, 3) + 10 * r for r in range(4)]
    for r, out in enumerate(res):
        d, m = mesh.coords(r)
        peers = [mesh.rank_of((d, j)) for j in range(2)]
        col = [mesh.rank_of((i, m)) for i in range(2)]
        want_y = torch.cat([xs[p][2 * m:2 * m + 2] for p in peers])
        assert torch.equal(out["y"].float(), want_y)
        assert torch.equal(out["g"].float(), torch.cat([xs[p] for p in col], 1))
        assert out["s"] == sum(float(x.sum()) for x in xs)
        # d/dx: the exchange's transpose of the peers' (r' + 1), 2 x from the
        # gather (summed over the data column: each copy's square), 1 from psum
        want = torch.empty(4, 3)
        for j, p in enumerate(peers):
            want[2 * j:2 * j + 2] = p + 1
        want += 2 * len(col) * xs[r] + 1
        assert torch.allclose(out["grad"].float(), want, rtol=1e-2)
        assert out["traffic"]["calls"] == 5 and out["traffic"]["bytes"] > 0


def _failing_rank(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank one fails")
    return mesh.rank


def test_spawn_ranks_raises_when_a_rank_fails():
    with pytest.raises(Exception, match="rank one fails"):
        spawn_ranks(_failing_rank, (1, 2), "gloo", "cpu", axes=AXES, timeout_s=60)
    with pytest.raises(ValueError, match="backend"):
        spawn_ranks(_failing_rank, (1, 2), "mpi", "cpu")
