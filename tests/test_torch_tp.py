"""The registry's tensor-parallel, FSDP and ZeRO-1 placement of the LM
weights run as per-rank programs (``models.transformer``'s forward on a
``dist.tp.Layout``, ``dist.step.tp_train_step``, the registry's multi-rank
LM cells, ``train.checkpoint.restore_checkpoint`` on a mesh,
``dist.roofline.tp_train_bytes``) against the reference's ``jax.jit``
with the same ``in_specs`` on the CPU.

The reference runs once per module in subprocesses with 4 host devices
(``--xla_force_host_platform_device_count=4``) on meshes with ``Auto``
axes (ROADMAP C16), each case one program jitted with ``NamedSharding``s
built from the reference's own ``lm_param_specs``, ``zero_spec_for`` (FSDP:
every leaf but the router, as its registry extends them) and
``opt_state_specs``, its config given ``ep_mesh`` as its registry gives
it.  Training cases: the loss, ``jax.grad`` and one AdamW step of the
reduced smollm-135m (tied head) and llama3.2-3b (untied) on (2, 2)
without and with FSDP and on (1, 4) (``wq`` sharded, ``wk``/``wv``
whole), the reduced Scout on (2, 2) without and with FSDP (the expert
leaves gathered by the layout, the reference's ``ep_fsdp``) and a 3-head
config whose attention the specs leave whole on (2, 2).  Serving cases:
prefill logits and cache and 2 decode steps of llama3.2-3b on (2, 2) and
(1, 4), and of Scout on (2, 2) at a capacity factor of 4.0 on both sides
(the reference's prefill then drops no token; its decode is the local
``S == 1`` branch, the port's the rank's experts summed over ``model``).
The port runs the same cases on 4 gloo ranks (``spawn_ranks``)
from the same numpy-seeded weights and tokens, the attention on
``"flash"`` (the kernel's plain version on the CPU) in some cases and on
``"xla"`` in the others; the reference always on ``"xla"``.

Tolerances (f32 throughout): the loss, every assembled gradient leaf, the
moments after the step, the logits and the caches within 1e-5 of the
largest magnitude of the reference's value (the products' and the sums
over ranks' order).  The updated parameters are held to the port's
one-rank AdamW on the assembled gradient within 1e-6, as
``test_torch_ep.py`` holds its step: the first step moves a parameter by
lr * g / (|g| + eps), which flips with a gradient's sign near 0, and the
reference's gradient and the port's differ there by rounding.
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
from repro_torch.dist.roofline import tp_decode_bytes, tp_train_bytes
from repro_torch.dist.sharding import (
    P,
    axes_for_mesh,
    from_shards,
    lm_cache_specs,
    lm_param_specs,
    local_shard,
    opt_state_specs,
    zero_spec_for,
)
from repro_torch.dist.step import (
    shard_tree,
    tp_train_step,
    tp_value_and_grad,
    zero1_train_step,
    zero_dim,
)
from repro_torch.dist.tp import Layout
from repro_torch.launch.mesh import Mesh, init_rank_mesh, spawn_ranks
from repro_torch.models import transformer as tf
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update, opt_state_shapes
from repro_torch.train.tree import flatten, map_leaves, unflatten


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
B, S = 4, 64
TOL = 1e-5
#: a config whose heads the specs leave whole on a model axis of 2 (3 heads,
#: 1 KV head) while its FFN and vocab split
WHOLE = "whole-heads"
WHOLE_KW = dict(name=WHOLE, n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=96,
                vocab=512)
#: (arch, mesh shape, FSDP, the port's attention)
TRAIN = [("smollm-135m", (2, 2), False, "xla"), ("smollm-135m", (2, 2), True, "xla"),
         ("smollm-135m", (1, 4), False, "flash"), ("llama3.2-3b", (2, 2), False, "xla"),
         ("llama3.2-3b", (2, 2), True, "flash"), ("llama3.2-3b", (1, 4), False, "xla"),
         ("llama4-scout-17b-a16e", (2, 2), False, "xla"), (WHOLE, (2, 2), False, "xla"),
         ("llama4-scout-17b-a16e", (2, 2), True, "xla")]
TRAIN_IDS = [f"{a}-{s[0]}x{s[1]}{'-fsdp' if f else ''}-{impl}" for a, s, f, impl in TRAIN]
#: (arch, mesh shape, the port's attention): prefill of S, 2 decode steps
SERVE = [("llama3.2-3b", (2, 2), "flash"), ("llama3.2-3b", (1, 4), "xla"),
         ("llama4-scout-17b-a16e", (2, 2), "xla")]
#: serving's capacity factor on both sides: the reference's prefill drops no
#: token, so its dispatch and the port's expert-parallel one agree
SERVE_CF = 4.0
SERVE_IDS = [f"{a}-{s[0]}x{s[1]}-{impl}" for a, s, impl in SERVE]
ARCHS = sorted({c[0] for c in TRAIN + SERVE})

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs.registry import get_arch_module, _maybe_axes
from repro.dist.sharding import (axes_for_mesh, dp_size, lm_cache_specs, lm_param_specs,
                                 opt_state_specs, zero_spec_for)
from repro.models import transformer as tf
from repro.train.optimizer import AdamWConfig, adamw_init, adamw_update

inp = np.load(sys.argv[1])
train, serve, whole_kw = eval(sys.argv[3]), eval(sys.argv[4]), eval(sys.argv[5])
cf = float(sys.argv[6])
B, S = inp["tokens"].shape


def config(arch):
    if arch == whole_kw["name"]:
        return tf.LMConfig(**whole_kw, param_dtype=jnp.float32, act_dtype=jnp.float32)
    return get_arch_module(arch).reduced_config()


def params_of(arch, cfg):
    treedef = jax.tree.structure(tf.abstract_params(cfg))
    return jax.tree.unflatten(treedef, [inp[f"{arch}_p{i}"] for i in range(treedef.num_leaves)])


def specs_of(cfg, mesh, fsdp):
    axes = axes_for_mesh(mesh)
    pabs = tf.abstract_params(cfg)
    ps = lm_param_specs(cfg, axes, mesh, pabs)
    dpn = dp_size(mesh, axes)
    if fsdp:
        def extend(path, spec, ab):
            return spec if path[-1].key == "router" else zero_spec_for(spec, ab.shape, axes, dpn)
        ps = jax.tree_util.tree_map_with_path(extend, ps, pabs,
                                              is_leaf=lambda x: isinstance(x, P))
    return axes, ps, opt_state_specs(ps, pabs, axes, dpn)


def place(mesh, x, specs):
    # numpy leaves onto the mesh in one transfer (eager JAX compiles an op a shape)
    return jax.device_put(x, jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                          is_leaf=lambda s: isinstance(s, P)))


def make_mesh(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


out = {}
tokens = jnp.asarray(inp["tokens"])
for i, (arch, shape, fsdp) in train.items():
    mesh, cfg = make_mesh(shape), config(arch)
    axes, ps, os_ = specs_of(cfg, mesh, fsdp)
    out[f"t{i}_specs"] = np.array(repr([tuple(s) for s in jax.tree.leaves(
        ps, is_leaf=lambda x: isinstance(x, P))]))
    cfgm = dataclasses.replace(cfg, ep_mesh=mesh, ep_dp_axes=tuple(axes.dp), ep_fsdp=fsdp)
    params = params_of(arch, cfg)

    def step(p, o, t):
        loss, g = jax.value_and_grad(lambda q: tf.forward_train(cfgm, q, t, t))(p)
        newp, newo = adamw_update(AdamWConfig(), p, g, o)
        return loss, g, newo

    with mesh:
        p = place(mesh, params, ps)
        zeros = jax.tree.map(np.zeros_like, params)
        o = place(mesh, {"m": zeros, "v": zeros, "step": np.zeros((), np.int32)}, os_)
        t = jax.device_put(tokens, NamedSharding(mesh, P("data", None)))
        loss, g, newo = jax.jit(step)(p, o, t)
    out[f"t{i}_loss"] = loss
    for j, leaf in enumerate(jax.tree.leaves(g)):
        out[f"t{i}_g{j}"] = leaf
    for j, leaf in enumerate(jax.tree.leaves(newo["m"])):
        out[f"t{i}_m{j}"] = leaf

for i, (arch, shape) in serve.items():
    mesh, cfg = make_mesh(shape), config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    axes, ps, _ = specs_of(cfg, mesh, False)
    cs = lm_cache_specs(cfg, axes, B, mesh)
    cfgm = dataclasses.replace(cfg, ep_mesh=mesh, ep_dp_axes=tuple(axes.dp), ep_fsdp=False)
    params = params_of(arch, cfg)
    with mesh:
        p = place(mesh, params, ps)
        t = jax.device_put(tokens, NamedSharding(mesh, P("data", None)))
        def prefill(q, x):
            logits, cache = tf.forward_prefill(cfgm, q, x)
            room = jax.tree.map(lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0))),
                                cache)
            return logits, cache, room

        cache_sh = jax.tree.map(lambda s: NamedSharding(mesh, s), cs,
                                is_leaf=lambda s: isinstance(s, P))
        logits, cache, room = jax.jit(prefill, out_shardings=(None, None, cache_sh))(p, t)
        out[f"s{i}_logits"] = logits
        for j, leaf in enumerate(jax.tree.leaves(cache)):
            out[f"s{i}_c{j}"] = leaf
        cache = room
        dec = jax.jit(lambda q, tok, c, pos: tf.forward_decode(cfg, q, tok, c, pos))
        tok_spec = NamedSharding(mesh, P(_maybe_axes(B, mesh, axes.dp)))
        for k in range(2):
            tok = jax.device_put(jnp.asarray(inp["decode"][:, k]), tok_spec)
            lg, cache = dec(p, tok, cache, jnp.int32(S + k))
            out[f"s{i}_d{k}"] = lg
        for j, leaf in enumerate(jax.tree.leaves(cache)):
            out[f"s{i}_e{j}"] = leaf
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("REF_OK")
"""


def _config(arch, impl="xla"):
    if arch == WHOLE:
        cfg = tf.LMConfig(**WHOLE_KW, param_dtype=torch.float32, act_dtype=torch.float32)
    else:
        cfg = treg.get_arch_module(arch).reduced_config()
    return dataclasses.replace(cfg, attention_impl=impl)


def _serve_config(arch, impl):
    cfg = _config(arch, impl)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=SERVE_CF))


def _specs(cfg, mesh, fsdp):
    """The port's (parameter, moment) specs by the registry's rules, FSDP
    forced as the registry turns it on (every leaf but the router)."""
    axes = axes_for_mesh(mesh)
    pabs = tf.init_params(cfg, None, device="meta")
    ps = lm_param_specs(cfg, axes, mesh, pabs)
    dpn = mesh.shape["data"]
    if fsdp:
        leaves, paths = flatten(pabs)
        ps = unflatten(ps, [s if p[-1] == "router" else zero_spec_for(s, tuple(a.shape), axes, dpn)
                            for s, a, p in zip(flatten(ps)[0], leaves, paths)])
    return ps, opt_state_specs(ps, pabs, axes, dpn)["m"]


def _inputs():
    rng = np.random.default_rng(11)
    arrays = {}
    for arch in ARCHS:
        shapes, paths = flatten(tf.param_shapes(_config(arch)))
        for i, (s, p) in enumerate(zip(shapes, paths)):
            arrays[f"{arch}_p{i}"] = (np.ones(s, np.float32) if p[-1].endswith("norm") else
                                      (rng.standard_normal(s) * 0.1).astype(np.float32))
    arrays["tokens"] = rng.integers(0, 512, (B, S)).astype(np.int32)
    arrays["decode"] = rng.integers(0, 512, (B, 2)).astype(np.int32)
    return arrays


def _full(inp, arch, cfg):
    n = len(flatten(tf.param_shapes(cfg))[0])
    return unflatten(tf.param_shapes(cfg), [torch.from_numpy(inp[f"{arch}_p{i}"])
                                            for i in range(n)])


def _block_checks(mesh):
    """Every LM and recsys cell of the registry at full size on this rank
    mesh: the blocks it hands the rank (``local_shard`` by its
    ``in_specs``, on ``meta``) are the ones its step reads, moments and
    caches included; a recsys table split over ``model`` is read as the
    ``RowBlock`` of the rank's rows."""
    from repro_torch.models.recsys import RowBlock, row_blocks

    bad = []
    for arch in treg.ALL_ARCHS:
        family = treg.get_arch_module(arch).FAMILY
        if family == "recsys":
            for shape in treg.ARCH_SHAPES[arch]:
                cell = treg.build_cell(arch, shape, mesh=mesh)
                params = shard_tree(cell.abstract_args[0], cell.in_specs[0], mesh)
                tp = mesh.group_size("model")
                for p, ab, w in zip(flatten(row_blocks(params, cell.in_specs[0], mesh))[0],
                                    flatten(cell.abstract_args[0])[0], flatten(params)[0]):
                    if isinstance(p, RowBlock) and (p.table is not w or p.lo != mesh.group_rank(
                            "model") * w.shape[0] or w.shape[0] * tp != ab.shape[0]):
                        bad.append((arch, shape, "rows"))
                if cell.kind == "train":
                    opt = shard_tree(cell.abstract_args[1], cell.in_specs[1], mesh)
                    for p, m, ps, ms in zip(flatten(params)[0], flatten(opt["m"])[0],
                                            flatten(cell.in_specs[0])[0],
                                            flatten(cell.in_specs[1]["m"])[0]):
                        zd = zero_dim(ps, ms, p.dim(), mesh)
                        want = list(p.shape)
                        if zd is not None:
                            want[zd] //= mesh.group_size("data")
                        if list(m.shape) != want:
                            bad.append((arch, shape, tuple(m.shape), want))
            continue
        if family != "lm":
            continue
        for shape in treg.ARCH_SHAPES[arch]:
            cell = treg.build_cell(arch, shape, mesh=mesh)
            cfg = treg.get_arch_module(arch).config()
            pspecs = cell.in_specs[0]
            params = shard_tree(cell.abstract_args[0], pspecs, mesh)
            if cell.kind == "train":
                Layout(cfg, mesh, pspecs, params)
                opt = shard_tree(cell.abstract_args[1], cell.in_specs[1], mesh)
                dr, dpn = mesh.group_rank("data"), mesh.group_size("data")
                for p, m, ps, ms in zip(flatten(params)[0], flatten(opt["m"])[0],
                                        flatten(pspecs)[0], flatten(cell.in_specs[1]["m"])[0]):
                    zd = zero_dim(ps, ms, p.dim(), mesh)
                    want = list(p.shape)
                    if zd is not None:
                        want[zd] //= dpn
                    if list(m.shape) != want:
                        bad.append((arch, shape, tuple(m.shape), want, dr))
                continue
            lay = Layout(cfg, mesh, pspecs, params)
            cache = shard_tree(cell.abstract_args[-2] if cell.kind == "decode"
                               else tf.init_cache(cfg, *cell.abstract_args[1].shape, "meta"),
                               cell.out_specs[1], mesh)
            rows, positions = flatten(cache)[0][0].shape[1:3]
            mine = tf.init_cache(cfg, rows, positions, "meta", layout=lay)
            if [c.shape for c in flatten(mine)[0]] != [c.shape for c in flatten(cache)[0]]:
                bad.append((arch, shape, "cache"))
    return bad


def _port_rank(mesh, path):
    inp = dict(np.load(path))
    meshes = {mesh.mesh.sizes: mesh}

    def rank_mesh(shape):
        if shape not in meshes:
            meshes[shape] = init_rank_mesh(shape, AXES, "gloo", "cpu")
        return meshes[shape]

    tokens = torch.from_numpy(inp["tokens"])
    out = {"train": [], "serve": []}
    for arch, shape, fsdp, impl in TRAIN:
        rm = rank_mesh(shape)
        cfg = _config(arch, impl)
        ps, ms = _specs(cfg, rm.mesh, fsdp)
        full = _full(inp, arch, cfg)
        params = shard_tree(full, ps, rm)
        tok = local_shard(tokens, P("data", None), rm.shape, dict(zip(AXES, rm.coords)))
        batch = {"tokens": tok, "labels": tok}
        opt = shard_tree(adamw_init(full), {"m": ms, "v": ms, "step": P()}, rm)
        seen = {}

        def value_and_grad(p, b, cfg=cfg, rm=rm, ps=ps, ms=ms):
            # tp_train_step's own composition, its gradient kept for the checks
            seen["loss"], seen["grads"] = tp_value_and_grad(cfg, rm, ps, ms, p, b)
            return seen["loss"], seen["grads"]

        rm.reset_traffic()
        newp, newo, sloss = zero1_train_step(value_and_grad, AdamWConfig(), rm, ps, ms)(
            params, opt, batch)
        out["train"].append({
            "loss": float(seen["loss"]), "step_loss": float(sloss),
            "grads": flatten(seen["grads"])[0],
            "params": flatten(newp)[0], "m": flatten(newo["m"])[0],
            "bytes": rm.traffic["bytes"],
            "formula": tp_train_bytes(cfg, rm, ps, ms, tuple(tok.shape))})
    for arch, shape, impl in SERVE:
        rm = rank_mesh(shape)
        cfg = _serve_config(arch, impl)
        ps, _ = _specs(cfg, rm.mesh, False)
        params = shard_tree(_full(inp, arch, cfg), ps, rm)
        lay = Layout(cfg, rm, ps, params)
        coords = dict(zip(AXES, rm.coords))
        tok = local_shard(tokens, P("data", None), rm.shape, coords)
        with torch.no_grad():
            logits, cache = tf.forward_prefill(cfg, params, tok, max_seq=S + 2, layout=lay)
            first = [c[:, :, :S].clone() for c in flatten(cache)[0]]
            dec = local_shard(torch.from_numpy(inp["decode"]), P("data", None), rm.shape, coords)
            steps = [tf.forward_decode(cfg, params, dec[:, k], cache, S + k, layout=lay)[0]
                     for k in range(2)]
        out["serve"].append({"logits": logits, "cache": first, "decode": steps,
                             "final": flatten(cache)[0]})
    out["registry"] = _registry_rank(mesh, inp)
    out["blocks"] = _block_checks(mesh)
    out["restore"] = _restore_rank(mesh, inp, os.path.join(os.path.dirname(path), "ckpt"))
    return out


def _registry_rank(mesh, inp):
    """The registry's reduced llama3.2-3b cells built on this rank mesh, on
    the same blocks and tokens as the cases above: the train step (one
    ZeRO-1 step), the prefill and a decode step."""
    arch = "llama3.2-3b"
    cfg = _config(arch)
    full = _full(inp, arch, cfg)
    coords = dict(zip(AXES, mesh.coords))
    tok = local_shard(torch.from_numpy(inp["tokens"]), P("data", None), mesh.shape, coords)
    train = treg.build_cell(arch, "train_4k", reduced=True, mesh=mesh)
    params = shard_tree(full, train.in_specs[0], mesh)
    opt = shard_tree(adamw_init(full), train.in_specs[1], mesh)
    newp, newo, loss = train.step_fn(params, opt, {"tokens": tok, "labels": tok})
    pre = treg.build_cell(arch, "prefill_32k", reduced=True, mesh=mesh)
    dec = treg.build_cell(arch, "decode_32k", reduced=True, mesh=mesh)
    with torch.no_grad():
        logits, cache = pre.step_fn(shard_tree(full, pre.in_specs[0], mesh), tok)
        cache = map_leaves(lambda c: torch.cat([c, torch.zeros_like(c[:, :, :2])], 2), cache)
        tokd = local_shard(torch.from_numpy(inp["decode"][:, 0]), dec.in_specs[1], mesh.shape,
                           coords)
        dlogits, _ = dec.step_fn(shard_tree(full, dec.in_specs[0], mesh), tokd, cache,
                                 torch.tensor(S))
    return {"params": flatten(newp)[0], "loss": float(loss), "step": int(newo["step"]),
            "shapes": [tuple(x.shape) for x in flatten(newp)[0]],
            "want_shapes": [tuple(x.shape) for x in flatten(shard_tree(
                full, train.out_specs[0], mesh))[0]],
            "logits": logits, "decode": dlogits}


def _restore_rank(mesh, inp, root):
    """C9: a whole checkpoint of llama3.2-3b's parameters and moments
    restored onto this rank's blocks (FSDP specs on (2, 2)), and one step
    from it, against the blocks cut from the whole tree and the step from
    them."""
    cfg = _config("llama3.2-3b")
    ps, ms = _specs(cfg, mesh.mesh, True)
    full = _full(inp, "llama3.2-3b", cfg)
    tree = {"params": full, "opt": adamw_init(full)}
    specs = {"params": ps, "opt": {"m": ms, "v": ms, "step": P()}}
    if mesh.rank == 0:
        save_checkpoint(root, 3, tree)
    torch.distributed.barrier()
    like = {"params": map_leaves(lambda x: torch.empty_like(x, device="meta"), full),
            "opt": opt_state_shapes(full)}
    got, step = restore_checkpoint(os.path.join(root, "step_0000000003"), like, mesh=mesh,
                                   specs=specs)
    want = shard_tree(tree, specs, mesh)
    same = all(torch.equal(a, b) and a.device == b.device
               for a, b in zip(flatten(got)[0], flatten(want)[0]))
    tok = local_shard(torch.from_numpy(inp["tokens"]), P("data", None), mesh.shape,
                      dict(zip(AXES, mesh.coords)))
    run = tp_train_step(cfg, AdamWConfig(), mesh, ps, ms)
    a = run(got["params"], got["opt"], {"tokens": tok, "labels": tok})
    b = run(want["params"], want["opt"], {"tokens": tok, "labels": tok})
    resumed = all(torch.equal(x, y) for x, y in zip(flatten(list(a[:2]))[0],
                                                    flatten(list(b[:2]))[0]))
    return {"step": step, "same": same, "resumed": resumed and float(a[2]) == float(b[2])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    # the reference's programs in four processes at once (their compiles are
    # most of this module's time), the port's ranks beside them
    parts = [({i: TRAIN[i][:3] for i in (0, 1, 2, 7)}, {0: SERVE[0][:2]}),
             ({i: TRAIN[i][:3] for i in (3, 4, 5)}, {1: SERVE[1][:2]}),
             ({6: TRAIN[6][:3]}, {2: SERVE[2][:2]}), ({8: TRAIN[8][:3]}, {})]
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REF, str(d / "in.npz"), str(d / f"ref{k}.npz"), repr(tr),
         repr(sv), repr(WHOLE_KW), repr(SERVE_CF)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, (tr, sv) in enumerate(parts)]
    try:
        port = spawn_ranks(_port_rank, (2, 2), "gloo", "cpu", args=(str(d / "in.npz"),),
                           axes=AXES, timeout_s=300)
    finally:
        done = [p.communicate(timeout=600) for p in refs]
    ref = {}
    for k, p in enumerate(refs):
        assert p.returncode == 0 and "REF_OK" in done[k][0], done[k][1][-3000:]
        ref.update(np.load(d / f"ref{k}.npz"))
    return inp, ref, port


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _assemble(port, kind, i, key, specs, shape):
    mesh = Mesh(AXES, shape)
    per = [r[kind][i][key] for r in port[:mesh.size]]
    return [from_shards([p[j] for p in per], s, mesh) for j, s in enumerate(flatten(specs)[0])]


@pytest.mark.parametrize("i", range(len(TRAIN)), ids=TRAIN_IDS)
def test_loss_and_gradient_match_the_reference(runs, i):
    _, ref, port = runs
    arch, shape, fsdp, impl = TRAIN[i]
    cfg = _config(arch, impl)
    ps, ms = _specs(cfg, Mesh(AXES, shape), fsdp)
    assert str(ref[f"t{i}_specs"]) == repr([tuple(s) for s in flatten(ps)[0]])
    loss = float(ref[f"t{i}_loss"])
    for r in port:
        assert abs(r["train"][i]["loss"] - loss) <= TOL * abs(loss)
        assert r["train"][i]["step_loss"] == r["train"][i]["loss"]
    for j, g in enumerate(_assemble(port, "train", i, "grads", ms, shape)):
        _close(g, ref[f"t{i}_g{j}"])


@pytest.mark.parametrize("i", range(len(TRAIN)), ids=TRAIN_IDS)
def test_zero1_adamw_step(runs, i):
    """One ZeRO-1 step: the moments within 1e-5 of the reference's; the
    parameters, put back together, within 1e-6 of the one-rank AdamW on the
    assembled gradient (module docstring)."""
    inp, ref, port = runs
    arch, shape, fsdp, impl = TRAIN[i]
    cfg = _config(arch, impl)
    ps, ms = _specs(cfg, Mesh(AXES, shape), fsdp)
    for j, m in enumerate(_assemble(port, "train", i, "m", ms, shape)):
        _close(m, ref[f"t{i}_m{j}"])
    full = _full(inp, arch, cfg)
    grads = unflatten(full, _assemble(port, "train", i, "grads", ms, shape))
    want, _ = adamw_update(AdamWConfig(), full, grads, adamw_init(full))
    for got, w in zip(_assemble(port, "train", i, "params", ps, shape), flatten(want)[0]):
        _close(got, w, 1e-6)


@pytest.mark.parametrize("i", range(len(TRAIN)), ids=TRAIN_IDS)
def test_collective_bytes_formula(runs, i):
    """``tp_train_bytes`` from the cell's shapes equals the bytes each rank's
    collectives counted in one step."""
    for r in runs[2]:
        assert r["train"][i]["bytes"] == r["train"][i]["formula"] > 0


@pytest.mark.parametrize("i", range(len(SERVE)), ids=SERVE_IDS)
def test_prefill_and_decode_match_the_reference(runs, i):
    """Logits and cache blocks of a prefill and 2 decode steps, put back
    together, against the reference's (Scout's at ``SERVE_CF``)."""
    _, want, port = runs
    arch, shape, impl = SERVE[i]
    cfg = _config(arch, impl)
    mesh = Mesh(AXES, shape)
    cs = lm_cache_specs(cfg, axes_for_mesh(mesh), B, mesh)
    logits_spec = P("data", "model")
    got = from_shards([r["serve"][i]["logits"] for r in port], logits_spec, mesh)
    _close(got, want[f"s{i}_logits"])
    for j, spec in enumerate(flatten(cs)[0]):
        _close(from_shards([r["serve"][i]["cache"][j] for r in port], spec, mesh),
               want[f"s{i}_c{j}"])
        _close(from_shards([r["serve"][i]["final"][j] for r in port], spec, mesh),
               want[f"s{i}_e{j}"])
    for k in range(2):
        got = from_shards([r["serve"][i]["decode"][k] for r in port], logits_spec, mesh)
        _close(got, want[f"s{i}_d{k}"])


def test_registry_cells_take_the_tensor_parallel_steps(runs):
    """``build_cell`` on a rank mesh of 4: the reduced llama3.2-3b train
    cell's step is the ZeRO-1 step (the same bits as the direct call on the
    same blocks; blocks of its ``out_specs``), its prefill and decode cells
    the per-rank forwards."""
    _, ref, port = runs
    i = TRAIN.index(("llama3.2-3b", (2, 2), False, "xla"))
    j = SERVE.index(("llama3.2-3b", (2, 2), "flash"))
    mesh = Mesh(AXES, (2, 2))
    for r in port:
        reg = r["registry"]
        assert reg["step"] == 1 and reg["shapes"] == reg["want_shapes"]
        assert reg["loss"] == r["train"][i]["step_loss"]
        assert all(torch.equal(a, b) for a, b in zip(reg["params"], r["train"][i]["params"]))
    _close(from_shards([r["registry"]["logits"] for r in port], P("data", "model"), mesh),
           ref[f"s{j}_logits"])
    _close(from_shards([r["registry"]["decode"] for r in port], P("data", "model"), mesh),
           ref[f"s{j}_d0"])


def test_every_lm_cell_hands_a_rank_its_local_shard(runs):
    """All 20 LM cells and 16 recsys cells at full size on the (2, 2) rank
    mesh: the parameter, moment and cache blocks the step reads are
    ``local_shard``'s by the cell's specs (``_block_checks``)."""
    for r in runs[2]:
        assert r["blocks"] == []


def test_restore_checkpoint_onto_a_mesh(runs):
    """C9: each rank restores its own blocks of a whole checkpoint (equal
    to ``local_shard`` of the saved tree), and a step resumed from them
    equals the step from the blocks cut in memory."""
    for r in runs[2]:
        assert r["restore"] == {"step": 3, "same": True, "resumed": True}


def test_kv_heads_of_sharded_queries():
    """The KV heads a rank's query heads take where ``wq`` splits and
    ``wk`` does not: a slice where they form equal contiguous groups, else
    one KV head a query head."""
    for H, K, tp, want in [(4, 2, 4, [[0], [0], [1], [1]]),
                           (8, 2, 4, [[0], [0], [1], [1]]),
                           (6, 3, 2, [[0, 0, 1], [1, 2, 2]]),
                           (12, 3, 2, [[0, 0, 0, 0, 1, 1], [1, 1, 2, 2, 2, 2]])]:
        for r in range(tp):
            lay = Layout.__new__(Layout)
            lay.cfg = tf.LMConfig(name="t", n_layers=1, d_model=8 * H, n_heads=H,
                                  n_kv_heads=K, d_ff=8, vocab=8)
            lay.tp, lay.r = tp, r
            lay.block = {"pos0": {"wq": (1, None), "wk": (None, None)}}
            k = torch.arange(K).reshape(1, 1, K, 1).float()
            got = lay.kv_heads(0, k)[0, 0, :, 0].long().tolist()
            assert got == want[r], (H, K, tp, r, got)
            # the view's groups of H_loc / K_loc query heads read these heads
            rep = (H // tp) // len(got)
            assert [got[j // rep] for j in range(H // tp)] == [
                h // (H // K) for h in range(r * H // tp, (r + 1) * H // tp)]


def test_dry_run_collective_term():
    """The dry run's collective term of an LM train cell on each production
    mesh is ``tp_train_bytes`` of a data shard of the cell's batch; a
    decode cell's is ``tp_decode_bytes`` of a rank's rows."""
    from repro_torch.dist.roofline import H100_NVLINK_BPS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    r = dryrun.run_cell("smollm-135m", "train_4k", reduced=True, verbose=False)
    for label, multi in dryrun.PRODUCTION_MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        cell = treg.build_cell("smollm-135m", "train_4k", reduced=True, mesh=mesh)
        B, S_ = cell.abstract_args[2]["tokens"].shape
        dp = mesh.size // mesh.shape["model"]
        want = tp_train_bytes(_config("smollm-135m"), mesh, cell.in_specs[0],
                              cell.in_specs[1]["m"], (B // dp, S_))
        got = r["collective"][label]
        assert got["chips"] == mesh.size and got["bytes_a_rank"] == want > 0
        assert got["roofline"]["collective_s"] == want / H100_NVLINK_BPS
    served = dryrun.run_cell("smollm-135m", "decode_32k", reduced=True, verbose=False)
    for label, multi in dryrun.PRODUCTION_MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        cell = treg.build_cell("smollm-135m", "decode_32k", reduced=True, mesh=mesh)
        rows = 128 // (mesh.size // mesh.shape["model"])
        want = tp_decode_bytes(_config("smollm-135m"), mesh, cell.in_specs[0], rows)
        assert served["collective"][label]["bytes_a_rank"] == want > 0
