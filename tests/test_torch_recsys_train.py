"""The port's recsys training path against the reference, on the CPU.

Each model at its ``reduced_config()`` on the reference's weights
(``tests/test_torch_recsys.model``) and ``recsys_batches`` batches:

- each ``*_train_loss`` and every gradient leaf against
  ``jax.value_and_grad`` (the lookups' gradients are dense scatter-adds);
- ``tree.flatten``'s order and ``treedef_str`` against ``jax.tree.flatten``
  and ``str(jax.tree.structure)`` on all four parameter trees (lists of
  blocks and MLP layers) and on an LM tree;
- one ``adamw_update`` on those gradients against the reference's;
- checkpoints of SASRec and DLRM (list-bearing trees) written by either
  package and restored by the other;
- three steps of the port's ``train`` against the reference's losses;
- ``recsys_batches`` equal to the reference's in both modes;
- ``launch.train.main`` in-process for the four architectures;
- the four configs' fields equal to the reference's.

Tolerances: losses within 1e-5 relative (eager against jitted f32:
summation order), each gradient leaf within rtol 1e-5 and an atol of 1e-5
of the leaf's largest magnitude (sums of terms of both signs); the AdamW
state as ``tests/test_torch_train.py`` holds it with the clip active, f32
leaves within 1e-6 of each leaf's largest magnitude; checkpoints and
batches exact.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_recsys import ARCHS, batch, model

from repro.data import pipelines as jpipe
from repro.models import recsys as J
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.data import pipelines as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models import recsys as T
from repro_torch.models import transformer as ttf
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import flatten, map_leaves, treedef_str


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_RTOL = GRAD_RTOL = 1e-5
CLIPPED_RTOL = 1e-6
LOSS = {"fm": "fm_train_loss", "sasrec": "sasrec_train_loss",
        "autoint": "autoint_train_loss", "dlrm-mlperf": "dlrm_train_loss"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _batches(arch, seed):
    b = batch(arch, seed=seed)
    b.pop("target", None)
    return b


def _jax_loss(arch):
    cfg = model(arch)["jcfg"]
    return lambda params, b: getattr(J, LOSS[arch])(cfg, params, b)


def _port_loss(arch):
    cfg = model(arch)["tcfg"]
    return lambda params, b: getattr(T, LOSS[arch])(cfg, params, b)


@functools.cache
def _grads(arch, seed=5):
    """(reference loss and gradients, the port's), f32, one batch."""
    m, b = model(arch), _batches(arch, seed)
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss(arch)))(
        m["jax"]["f32"], {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = tloop.value_and_grad(_port_loss(arch), m["port"]["f32"],
                                  {k: torch.as_tensor(v) for k, v in b.items()})
    return (jl, jg), (tl, tg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_loss_and_gradients_match_reference(arch):
    (jl, jg), (tl, tg) = _grads(arch)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    jleaves, tleaves = jax.tree.leaves(jg), flatten(tg)[0]
    assert len(jleaves) == len(tleaves)
    for w, g in zip(jleaves, tleaves):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(w).max()))
    # the tables' gradients are sparse: rows no id named stay zero
    table = "item_emb" if arch == "sasrec" else "emb"
    assert not tg[table][np.asarray(jg[table]).any(axis=1) == 0].any()


def _lm_tree():
    """An LM's parameter layout in both packages (shapes only)."""
    cfg = jtf.LMConfig(name="t", n_layers=2, d_model=16, n_heads=2, n_kv_heads=1, d_ff=32,
                       vocab=23, param_dtype=jnp.float32, act_dtype=jnp.float32)
    jp = jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = ttf.LMConfig(name="t", n_layers=2, d_model=16, n_heads=2, n_kv_heads=1, d_ff=32,
                        vocab=23, param_dtype=torch.float32, act_dtype=torch.float32)
    return jp, ttf.init_params(tcfg, None, device="meta")


@pytest.mark.parametrize("arch", [*sorted(ARCHS), "lm"])
def test_tree_order_matches_jax(arch):
    if arch == "lm":
        jp, tp = _lm_tree()
    else:
        jp, tp = model(arch)["jax"]["f32"], model(arch)["port"]["f32"]
    for jt, tt in ((jp, tp), ({"params": jp, "opt": jopt.adamw_init(jp)},
                              {"params": tp, "opt": topt.adamw_init(tp)})):
        leaves, paths = flatten(tt)
        jpaths = jax.tree_util.tree_flatten_with_path(jt)[0]
        assert paths == [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
                         for p, _ in jpaths]
        assert treedef_str(tt) == str(jax.tree.structure(jt))
        for g, (_, w) in zip(leaves, jpaths):
            assert tuple(g.shape) == w.shape
            if arch != "lm" and jt is jp:  # the same weights
                np.testing.assert_array_equal(_np(g), _np(w))
    if arch == "sasrec":
        assert treedef_str(tp).count("[{") == 1 and flatten(tp)[1][0][:2] == ("blocks", 0)


@pytest.mark.parametrize("arch", ("autoint", "dlrm-mlperf"))
def test_adamw_update_matches_reference(arch):
    """One update (clip active) on the reference's gradients, from a state
    whose moments are not zero."""
    (_, jg), _ = _grads(arch)
    jp = model(arch)["jax"]["f32"]
    tg = map_leaves(lambda g: torch.from_numpy(np.array(g)), jax.tree.map(np.asarray, jg))
    tp = model(arch)["port"]["f32"]
    jcfg, tcfg = jopt.AdamWConfig(grad_clip=1e-3), topt.AdamWConfig(grad_clip=1e-3)
    assert float(topt.global_norm(tg)) > 1e-3
    js = {"m": jax.tree.map(lambda g: g * 3, jg), "v": jax.tree.map(lambda g: g * g, jg),
          "step": jnp.int32(4)}
    ts = {"m": map_leaves(lambda g: g * 3, tg), "v": map_leaves(lambda g: g * g, tg),
          "step": torch.tensor(4, dtype=torch.int32)}
    jp2, js2 = jax.jit(functools.partial(jopt.adamw_update, jcfg))(jp, jg, js)
    tp2, ts2 = topt.adamw_update(tcfg, tp, tg, ts)
    assert int(ts2["step"]) == 5
    for want, got in ((jp2, tp2), (js2["m"], ts2["m"]), (js2["v"], ts2["v"])):
        for w, g in zip(jax.tree.leaves(want), flatten(got)[0]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=CLIPPED_RTOL * float(np.abs(w).max()) + 1e-30)


def _state(arch, pkg):
    m = model(arch)
    if pkg == "jax":
        p = m["jax"]["f32"]
        return {"params": p, "opt": {"m": jax.tree.map(lambda x: x * 2, p),
                                     "v": jax.tree.map(lambda x: x * x, p),
                                     "step": jnp.int32(7)}}
    p = m["port"]["f32"]
    return {"params": p, "opt": {"m": map_leaves(lambda x: x * 2, p),
                                 "v": map_leaves(lambda x: x * x, p),
                                 "step": torch.tensor(7, dtype=torch.int32)}}


@pytest.mark.parametrize("arch", ("sasrec", "dlrm-mlperf"))
def test_checkpoint_written_by_the_port_restores_in_the_reference(arch, tmp_path):
    tstate = _state(arch, "torch")
    path = tckpt.save_checkpoint(str(tmp_path), 3, tstate)
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["treedef"] == str(jax.tree.structure(_state(arch, "jax")))
    restored, step = jckpt.restore_checkpoint(path, _state(arch, "jax"))
    assert step == 3
    for w, g in zip(jax.tree.leaves(restored), flatten(tstate)[0]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("arch", ("sasrec", "dlrm-mlperf"))
def test_checkpoint_written_by_the_reference_restores_in_the_port(arch, tmp_path):
    jstate = _state(arch, "jax")
    path = jckpt.save_checkpoint(str(tmp_path), 4, jstate)
    restored, step = tckpt.restore_checkpoint(path, _state(arch, "torch"), device="cpu")
    assert step == 4
    for w, g in zip(jax.tree.leaves(jstate), flatten(restored)[0]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # m (2p) and v (p^2) have the same shapes: only the order tells them apart
    leaf = (lambda t: t["blocks"][1]["w1"]) if arch == "sasrec" else (lambda t: t["top_w"][1])
    np.testing.assert_array_equal(leaf(restored["opt"]["v"]).numpy(),
                                  np.asarray(leaf(jstate["opt"]["v"])))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_three_steps_match_the_reference_loop(arch, tmp_path):
    m = model(arch)
    want = jloop.train(_jax_loss(arch), lambda: m["jax"]["f32"],
                       lambda step: _batches(arch, 10 + step), n_steps=3,
                       ckpt_dir=str(tmp_path / "j"), ckpt_every=100)
    got = tloop.train(_port_loss(arch), lambda: map_leaves(torch.clone, m["port"]["f32"]),
                      lambda step: _batches(arch, 10 + step), n_steps=3,
                      ckpt_dir=str(tmp_path / "t"), ckpt_every=100, device="cpu")
    assert (got.final_step, got.restarts) == (3, 0)
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)
    # the port's last checkpoint restores in the reference
    restored, step = jckpt.restore_checkpoint(
        tckpt.latest_checkpoint(str(tmp_path / "t"))[1],
        {"params": m["jax"]["f32"], "opt": jopt.adamw_init(m["jax"]["f32"])})
    assert step == 3 and int(restored["opt"]["step"]) == 3


@pytest.mark.parametrize("mode", ("criteo", "dense", "sasrec"))
def test_recsys_batches_match_reference(mode):
    if mode == "sasrec":
        args, kw = ((), 6), dict(seq_len=12, n_items=500, seed=4)
    else:
        args, kw = ((3, 50, 7000, 2), 6), dict(n_dense=13 if mode == "dense" else 0, seed=4)
    got, want = tpipe.recsys_batches(*args, **kw), jpipe.recsys_batches(*args, **kw)
    for _ in range(3):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    if mode == "sasrec":
        assert g["item_seq"].min() >= 1 and g["neg_items"].max() < 500
    else:
        assert (g["sparse"] >= 0).all() and (g["sparse"] < np.array(args[0])).all()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cli_trains_on_the_cpu_in_process(arch, tmp_path, capsys):
    tlaunch.main(["--arch", arch, "--steps", "2", "--device", "cpu", "--batch", "4",
                  "--ckpt", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[{arch}] steps=2 loss ") and "restarts=0" in line
    assert [s for s, _ in tckpt.list_checkpoints(str(tmp_path))] == [2]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_match_reference(arch):
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg

    mod, jmod = treg.get_arch_module(arch), jreg.get_arch_module(arch)
    assert (mod.ARCH_ID, mod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY) == (arch, "recsys")
    for make in ("config", "reduced_config"):
        got, want = getattr(mod, make)(), getattr(jmod, make)()
        assert [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if f.name == "param_dtype":
                assert str(g).removeprefix("torch.") == jnp.dtype(w).name
            else:
                assert g == w, (arch, make, f.name)
