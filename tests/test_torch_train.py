"""The port's training substrate against the reference, on the CPU:
parameter trees, AdamW, int8 error-feedback compression, checkpoints
(interchanged both ways), the fault-tolerant loop, the LM batch pipeline,
the architecture registry and the ``launch.train`` CLI.

Tolerances: the AdamW state after three unclipped updates and the
compression payloads and scales are held within 1 f32 ulp of the
reference's (bf16 leaves compared in f32, so equal bit for bit; measured:
identical); with the clip active, whose scale comes from a norm summed in
another order, f32 leaves within 1e-6 of each leaf's largest magnitude and
bf16 leaves within one bf16 ulp; the compression error within 1 ulp;
restored checkpoints bit for bit; the loop's losses within 1e-5 relative
of the reference loop's on the same weights and batches (eager against
jitted f32: summation order), and a
resumed run's losses equal to the uninterrupted run's bit for bit.  The
compressed run tracks the uncompressed one within 0.25, the reference's
own parity bound (``tests/test_train_infra.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import pipelines as jpipe
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import pipelines as tpipe
from repro_torch.models import nequip as tnequip
from repro_torch.models import transformer as ttf
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import flatten, map_leaves, treedef_str, unflatten


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
LOOP_RTOL = 1e-5
PARITY_BOUND = 0.25
CLIPPED_RTOL = 1e-6

JCFG = jtf.LMConfig(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                    vocab=61, param_dtype=jnp.float32, act_dtype=jnp.float32)
TCFG = ttf.LMConfig(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                    vocab=61, param_dtype=torch.float32, act_dtype=torch.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_ulps(got, want, maxulp=1):
    np.testing.assert_array_max_ulp(_np(got), _np(want), maxulp=maxulp)


@pytest.fixture(scope="module")
def lm_weights():
    """The tiny LM's reference weights and the port's copy of them."""
    jparams = jtf.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(TCFG, jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _batch(step):
    t = np.random.default_rng(step).integers(0, 61, (4, 16)).astype(np.int32)
    return {"tokens": t, "labels": t}


def _jax_batch(step):
    return {k: jnp.asarray(v) for k, v in _batch(step).items()}


def _loss(params, batch):
    return ttf.forward_train(TCFG, params, batch["tokens"], batch["labels"])


def _jax_loss(params, batch):
    return jtf.forward_train(JCFG, params, batch["tokens"], batch["labels"])


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

NESTED = {"params": {"b": 1, "a": {"x": 2, "c": 3}}, "opt": {"v": 4, "step": 5, "m": 6}}


def test_flatten_orders_as_jax():
    leaves, paths = flatten(NESTED)
    assert leaves == jax.tree.leaves(NESTED)
    assert paths == [tuple(k.key for k in p)
                     for p, _ in jax.tree_util.tree_flatten_with_path(NESTED)[0]]
    assert treedef_str(NESTED) == str(jax.tree.structure(NESTED))
    back = unflatten(NESTED, leaves)
    assert back == NESTED and list(back) == list(NESTED)  # like's key order kept
    assert map_leaves(lambda a, b: a + b, NESTED, NESTED)["opt"]["m"] == 12
    with pytest.raises(ValueError, match="fewer"):
        unflatten(NESTED, leaves[:-1])
    with pytest.raises(ValueError, match="more"):
        unflatten(NESTED, leaves + [7])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

#: leaf shapes and dtypes of the optimizer tests' tree
OPT_TREE = {"a": ((3, 5), "f32"), "b": {"c": ((7,), "f32"), "d": ((4, 4), "bf16")}}


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    leaves = [x for x in jax.tree.leaves(OPT_TREE, is_leaf=lambda t: isinstance(t, tuple))]
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape, _ in leaves]
    jax_t = [jnp.asarray(a, jnp.bfloat16 if dt == "bf16" else jnp.float32)
             for a, (_, dt) in zip(arrays, leaves)]
    torch_t = [torch.from_numpy(a).to(torch.bfloat16 if dt == "bf16" else torch.float32)
               for a, (_, dt) in zip(arrays, leaves)]
    like = {"a": 0, "b": {"c": 0, "d": 0}}
    return unflatten(like, jax_t), unflatten(like, torch_t)


@pytest.mark.parametrize("moments", ("f32", "bf16"))
@pytest.mark.parametrize("clip", (None, 1e-2), ids=("no-clip", "clipped"))
def test_adamw_three_steps_match_reference(clip, moments):
    jcfg = jopt.AdamWConfig(grad_clip=clip,
                            moment_dtype=jnp.bfloat16 if moments == "bf16" else jnp.float32)
    tcfg = topt.AdamWConfig(grad_clip=clip,
                            moment_dtype=torch.bfloat16 if moments == "bf16" else torch.float32)
    jp, tp = _opt_trees(0)
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    for step in range(3):
        jg, tg = _opt_trees(step + 1)
        if clip is not None:  # the clip is active: the norm is far above it
            assert float(topt.global_norm(tg)) > 10 * clip
            np.testing.assert_allclose(float(topt.global_norm(tg)), float(jopt.global_norm(jg)),
                                       rtol=1e-6)
        jp, js = jopt.adamw_update(jcfg, jp, jg, js)
        tp, ts = topt.adamw_update(tcfg, tp, tg, ts)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == () and int(ts["step"]) == 3
    for name, want, got in (("params", jp, tp), ("m", js["m"], ts["m"]), ("v", js["v"], ts["v"])):
        for w, g in zip(jax.tree.leaves(want), flatten(got)[0]):
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
            if clip is None:
                _assert_ulps(g, w)
            elif g.dtype == torch.bfloat16:
                # the clip's scale may differ by one f32 ulp (the norm is
                # summed in another order), which can move a bf16 rounding
                np.testing.assert_allclose(_np(g), _np(w), rtol=2**-8, atol=1e-30)
            else:
                # that ulp, through the moments' sums of terms of both signs
                np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                           atol=CLIPPED_RTOL * float(np.abs(_np(w)).max()))


def test_opt_state_shapes_match_abstract_opt_state():
    jp, tp = _opt_trees(0)
    cfg = topt.AdamWConfig(moment_dtype=torch.bfloat16)
    want = jopt.abstract_opt_state(jp, jopt.AdamWConfig(moment_dtype=jnp.bfloat16))
    got = topt.opt_state_shapes(tp, cfg)
    for w, g in zip(jax.tree.leaves(want), flatten(got)[0]):
        assert g.device.type == "meta" and tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ((1000,), (256,), (3, 257), (5,)))
def test_compress_leaf_matches_reference(shape):
    rng = np.random.default_rng(7)
    g = rng.standard_normal(shape).astype(np.float32)
    e = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    q, s, ne = jcomp.compress_leaf(jnp.asarray(g), jnp.asarray(e))
    tq, ts, tne = tcomp.compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == q.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    _assert_ulps(tne, ne)
    np.testing.assert_array_equal(tcomp.decompress_leaf(tq, ts, shape).numpy(),
                                  np.asarray(jcomp.decompress_leaf(q, s, shape)))


def test_round_half_to_even():
    """A block whose scale makes x / scale land on halves: both round to even."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5] + [0.0] * 250, np.float32)
    q, _, _ = jcomp.compress_leaf(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
    tq, _, _ = tcomp.compress_leaf(torch.from_numpy(x), torch.zeros(256))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))


def test_compressed_grads_and_ratio_match_reference(lm_weights):
    jparams, tparams = lm_weights
    jg = jax.tree.map(lambda p: p * 0.37 + 0.01, jparams)
    tg = map_leaves(lambda p: p * 0.37 + 0.01, tparams)
    jerr, terr = jcomp.init_error_state(jparams), tcomp.init_error_state(tparams)
    for _ in range(3):
        jeff, jerr = jcomp.compressed_grads(jg, jerr)
        teff, terr = tcomp.compressed_grads(tg, terr)
    for w, g in zip(jax.tree.leaves(jeff) + jax.tree.leaves(jerr),
                    flatten(teff)[0] + flatten(terr)[0]):
        _assert_ulps(g, w)
    assert tcomp.compression_ratio(tg) == jcomp.compression_ratio(jg) < 0.3


def test_error_feedback_accumulates():
    g = {"w": torch.full((512,), 1e-4)}  # below one quantization step
    err = tcomp.init_error_state(g)
    total = torch.zeros(512)
    for _ in range(200):
        eff, err = tcomp.compressed_grads(g, err)
        total += eff["w"]
    np.testing.assert_allclose(total.numpy(), 200 * 1e-4, rtol=0.05)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state(jparams, tparams):
    return ({"params": jparams, "opt": jopt.adamw_init(jparams)},
            {"params": tparams, "opt": topt.adamw_init(tparams)})


def test_checkpoint_written_by_the_port_restores_in_the_reference(lm_weights, tmp_path):
    jstate, tstate = _state(*lm_weights)
    tstate["opt"]["m"] = map_leaves(lambda p: p * 2, tstate["params"])  # m and v differ
    tstate["opt"]["v"] = map_leaves(lambda p: p * p, tstate["params"])
    tstate["opt"]["step"] = torch.tensor(17, dtype=torch.int32)
    path = tckpt.save_checkpoint(str(tmp_path / "t"), 5, tstate)
    assert os.path.exists(os.path.join(path, "COMMITTED"))
    restored, step = jckpt.restore_checkpoint(path, jstate)
    assert step == 5
    for w, g in zip(jax.tree.leaves(restored), flatten(tstate)[0]):
        assert w.shape == tuple(g.shape)
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # the same files the reference writes for the same tree
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 5, restored)
    names = sorted(os.listdir(jpath))
    assert names == sorted(os.listdir(path))
    for name in names:
        if name.endswith(".npy"):
            assert Path(path, name).read_bytes() == Path(jpath, name).read_bytes(), name
    for p in (path, jpath):
        with open(os.path.join(p, "manifest.json")) as f:
            assert json.load(f) == {"step": 5, "n_leaves": len(flatten(tstate)[0]),
                                    "treedef": treedef_str(tstate)}


def test_checkpoint_written_by_the_reference_restores_in_the_port(lm_weights, tmp_path):
    jstate, tstate = _state(*lm_weights)
    jstate["opt"]["m"] = jax.tree.map(lambda p: p * 2, jstate["params"])
    jstate["opt"]["v"] = jax.tree.map(lambda p: p * p, jstate["params"])
    jstate["opt"]["step"] = jnp.int32(9)
    path = jckpt.save_checkpoint(str(tmp_path), 9, jstate)
    restored, step = tckpt.restore_checkpoint(path, tstate, device="cpu")
    assert step == 9
    for w, g in zip(jax.tree.leaves(jstate), flatten(restored)[0]):
        assert g.dtype == (torch.int32 if w.dtype == jnp.int32 else torch.float32)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # m and v have the same shapes: only the order tells them apart
    np.testing.assert_array_equal(restored["opt"]["m"]["embed"].numpy(),
                                  np.asarray(jstate["params"]["embed"]) * 2)
    # and onto a meta-shaped tree (opt_state_shapes)
    like = {"params": map_leaves(lambda p: p.to("meta"), tstate["params"]),
            "opt": topt.opt_state_shapes(tstate["params"])}
    again, _ = tckpt.restore_checkpoint(path, like, device="cpu")
    for a, b in zip(flatten(again)[0], flatten(restored)[0]):
        assert torch.equal(a, b)


def test_bf16_checkpoints(tmp_path):
    """bf16 leaves are stored as the reference stores them (two-byte void
    records of the bits); the port restores them bit for bit, from its own
    files and from the reference's, where the reference's own restore
    cannot cast them (ROADMAP C8)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 7)).astype(np.float32)
    ttree = {"w": torch.from_numpy(x).bfloat16(), "s": torch.tensor(3, dtype=torch.int32)}
    jtree = {"w": jnp.asarray(x, jnp.bfloat16), "s": jnp.int32(3)}
    tpath = tckpt.save_checkpoint(str(tmp_path / "t"), 1, ttree)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 1, jtree)
    for path in (tpath, jpath):
        assert np.load(os.path.join(path, "leaf_00001.npy")).dtype == np.dtype("V2")
        restored, _ = tckpt.restore_checkpoint(path, ttree, device="cpu")
        assert restored["w"].dtype == torch.bfloat16
        assert torch.equal(restored["w"].view(torch.int16), ttree["w"].view(torch.int16))
        assert torch.equal(restored["s"], ttree["s"])
        f32, _ = tckpt.restore_checkpoint(path, {"s": ttree["s"], "w": torch.zeros(6, 7)},
                                          device="cpu")
        assert torch.equal(f32["w"], ttree["w"].float())
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore_checkpoint(tpath, jtree)


def test_restore_rejects_another_tree(tmp_path):
    path = tckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="tree structure changed"):
        tckpt.restore_checkpoint(path, {"w": torch.ones(3), "x": torch.ones(1)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, {"w": torch.ones(4)}, device="cpu")


def test_checkpoint_uncommitted_ignored(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    bad = tmp_path / "step_0000000002"
    bad.mkdir()
    (bad / "leaf_00000.npy").write_bytes(b"junk")
    (tmp_path / ".tmp-step_0000000003").mkdir()
    assert tckpt.latest_checkpoint(str(tmp_path))[0] == 1
    assert tckpt.list_checkpoints(str(tmp_path / "missing")) == []
    assert tckpt.latest_checkpoint(str(tmp_path / "missing")) is None


def test_checkpoint_prune(tmp_path):
    for s in range(6):
        tckpt.save_checkpoint(str(tmp_path), s, {"w": torch.ones(3)})
    tckpt.prune_checkpoints(str(tmp_path), keep=2)
    assert [s for s, _ in tckpt.list_checkpoints(str(tmp_path))] == [4, 5]


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def _port_train(tparams, ckpt_dir, **kw):
    init = lambda: map_leaves(torch.clone, tparams)  # noqa: E731
    return tloop.train(_loss, init, _batch, ckpt_dir=str(ckpt_dir), device="cpu", **kw)


def test_loop_matches_the_reference_loop(lm_weights, tmp_path):
    jparams, tparams = lm_weights
    want = jloop.train(_jax_loss, lambda: jparams, _jax_batch, n_steps=5,
                       ckpt_dir=str(tmp_path / "j"), ckpt_every=100)
    got = _port_train(tparams, tmp_path / "t", n_steps=5, ckpt_every=100)
    assert (got.final_step, got.restarts, got.straggler_steps) == (5, 0, 0)
    assert len(got.step_seconds) == 5
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOOP_RTOL)
    # the last step's checkpoint restores in the reference
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    restored, step = jckpt.restore_checkpoint(jckpt.latest_checkpoint(str(tmp_path / "t"))[1],
                                              jstate)
    assert step == 5 and int(restored["opt"]["step"]) == 5


def test_resume_after_injected_failure_is_bit_identical(lm_weights, tmp_path):
    _, tparams = lm_weights
    base = _port_train(tparams, tmp_path / "a", n_steps=8, ckpt_every=4)
    failure = tloop.FailureInjector(fail_at_step=6)
    res = tloop.train_with_recovery(_loss, lambda: map_leaves(torch.clone, tparams), _batch,
                                    n_steps=8, ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
                                    failure=failure, device="cpu")
    assert failure.fired and res.final_step == 8 and res.restarts == 2
    # the second attempt resumed from step 4's checkpoint
    assert res.losses == base.losses[4:]
    assert [s for s, _ in tckpt.list_checkpoints(str(tmp_path / "b"))] == [4, 8]
    with pytest.raises(RuntimeError, match="injected failure"):
        tloop.train_with_recovery(_loss, lambda: tparams, _batch, n_steps=8,
                                  ckpt_dir=str(tmp_path / "c"), ckpt_every=100,
                                  failure=tloop.FailureInjector(fail_at_step=1),
                                  max_restarts=0, device="cpu")


def test_training_loss_decreases(lm_weights, tmp_path):
    _, tparams = lm_weights
    fixed = _batch(0)
    res = tloop.train(_loss, lambda: tparams, lambda step: fixed, n_steps=30,
                      ckpt_dir=str(tmp_path), ckpt_every=50, device="cpu",
                      opt_cfg=topt.AdamWConfig(lr=1e-2, weight_decay=0.0))
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])


def test_compressed_training_parity(lm_weights, tmp_path):
    _, tparams = lm_weights
    kw = dict(n_steps=25, ckpt_every=100, opt_cfg=topt.AdamWConfig(lr=1e-2, weight_decay=0.0))
    base = _port_train(tparams, tmp_path / "a", **kw)
    comp = _port_train(tparams, tmp_path / "b", compress_grads=True, **kw)
    assert comp.losses != base.losses
    assert abs(np.mean(comp.losses[-5:]) - np.mean(base.losses[-5:])) < PARITY_BOUND


# ---------------------------------------------------------------------------
# data, registry, CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", (None, "corpus"))
def test_lm_batches_match_reference(text):
    corpus = np.random.default_rng(1).integers(0, 1000, 5000) if text else None
    want = jpipe.lm_batches(100, 4, 16, seed=3, text=corpus)
    got = tpipe.lm_batches(100, 4, 16, seed=3, text=corpus)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in w:
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


def test_prefetcher():
    it = tpipe.Prefetcher(tpipe.lm_batches(vocab=100, batch=4, seq=8))
    want = jpipe.lm_batches(vocab=100, batch=4, seq=8)
    for _ in range(4):
        b = next(it)
        assert b["tokens"].shape == (4, 8) and b["tokens"].max() < 100
        np.testing.assert_array_equal(b["tokens"], next(want)["tokens"])
    it.close()


def test_registry_names_the_reference_archs():
    assert treg.ALL_ARCHS == jreg.ALL_ARCHS
    for arch in ("llama3.2-3b", "smollm-135m"):
        mod, jmod = treg.get_arch_module(arch), jreg.get_arch_module(arch)
        assert (mod.ARCH_ID, mod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY)
        for make in ("config", "reduced_config"):
            got, want = getattr(mod, make)(), getattr(jmod, make)()
            for f in dataclasses.fields(want):
                g, w = getattr(got, f.name), getattr(want, f.name)
                if f.name in ("param_dtype", "act_dtype"):
                    assert str(g).removeprefix("torch.") == jnp.dtype(w).name
                else:
                    assert g == w, (arch, make, f.name)
    with pytest.raises(KeyError):
        treg.get_arch_module("gpt-5")


def _same_config_field(got, want) -> bool:
    """A config field of the port against the reference's: dtypes by name,
    nested config dataclasses (``MoEConfig``) field by field."""
    if dataclasses.is_dataclass(want):
        return type(got).__name__ == type(want).__name__ and all(
            _same_config_field(getattr(got, f.name), getattr(want, f.name))
            for f in dataclasses.fields(want))
    if isinstance(got, torch.dtype):
        return str(got).removeprefix("torch.") == jnp.dtype(want).name
    return got == want


@pytest.mark.parametrize("arch", jreg.ALL_ARCHS)
def test_arch_config_matches_the_reference(arch):
    mod, jmod = treg.get_arch_module(arch), jreg.get_arch_module(arch)
    assert (mod.ARCH_ID, mod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY)
    assert getattr(mod, "OPT_MOMENT_DTYPE", None) == getattr(jmod, "OPT_MOMENT_DTYPE", None)
    for make in ("config", "reduced_config"):
        got, want = getattr(mod, make)(), getattr(jmod, make)()
        assert ({f.name for f in dataclasses.fields(got)}
                == {f.name for f in dataclasses.fields(want)}), (arch, make)
        for f in dataclasses.fields(want):
            assert _same_config_field(getattr(got, f.name), getattr(want, f.name)), (
                arch, make, f.name)


def test_cli_trains_nequip_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    main(["--arch", "nequip", "--steps", "3", "--device", "cpu", "--ckpt", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[nequip] steps=3 loss ") and "restarts=0" in line
    assert [s for s, _ in tckpt.list_checkpoints(str(tmp_path))] == [3]
    params = tnequip.abstract_params(treg.get_arch_module("nequip").reduced_config())
    like = {"params": params, "opt": topt.opt_state_shapes(params)}
    restored, step = tckpt.restore_checkpoint(tckpt.latest_checkpoint(str(tmp_path))[1], like,
                                              device="cpu")
    assert step == 3 and int(restored["opt"]["step"]) == 3
    assert all(torch.isfinite(x).all() for x in flatten(restored["params"])[0])


def test_cli_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-135m", "--steps",
         "3", "--device", "cpu", "--ckpt", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[smollm-135m] steps=3 loss ") and "restarts=0" in line
    assert [s for s, _ in tckpt.list_checkpoints(str(tmp_path))] == [3]
