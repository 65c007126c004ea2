"""The port's dense LM serving steps against the reference, on the CPU.

``forward_prefill`` (logits and KV cache) and two ``forward_decode`` steps of
``repro.models.transformer`` and ``repro_torch.models.transformer`` on the
same weights (the reference's ``init_params``, carried over by
``convert.lm_params_from_numpy``) and the same numpy-seeded tokens, for the
reduced ``llama3.2-3b`` and ``smollm-135m`` configurations under both
attention paths.  The reference's flash path runs its Pallas kernel in
interpret mode off a TPU; the port's runs the kernel's plain version on CPU
tensors (the CUDA kernel is held against it on the card by
``chip_smoke.py``).

Tolerances: 1e-5 in f32 (the reference's own flash and einsum paths already
differ by about 1.5e-7 at 2 x 64 tokens; the rest is summation order).  In
bf16 the two frameworks round at different places (matmul outputs, SiLU,
the softmax cast), so the logits are held to 2.5e-2 absolute: three bf16
ulps at |logit| in [1, 2) (the reduced models' logits stay below 1.1; the
measured gap is one ulp).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_3b as jax_llama
from repro.configs import smollm_135m as jax_smollm
from repro.models import transformer as jtf
from repro_torch.configs import llama3_2_3b, smollm_135m
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import transformer as ttf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = {"llama3.2-3b": (jax_llama, llama3_2_3b), "smollm-135m": (jax_smollm, smollm_135m)}
IMPLS = ("flash", "xla")
F32_TOL = 1e-5
BF16_TOL = 2.5e-2
B, S, STEPS = 2, 64, 2


def _configs(arch, impl, bf16=False):
    jmod, tmod = ARCHS[arch]
    jcfg = dataclasses.replace(jmod.reduced_config(), attention_impl=impl)
    tcfg = dataclasses.replace(tmod.reduced_config(), attention_impl=impl)
    if bf16:
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16, act_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch, impl, bf16=False, seed=0):
    jcfg, tcfg = _configs(arch, impl, bf16)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = lm_params_from_numpy(tcfg, _np_tree(jparams), device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (B, S + STEPS)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_matches_reference(arch, impl):
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch, impl)
    want, jcache = jtf.forward_prefill(jcfg, jparams, jnp.asarray(tokens[:, :S]))
    got, cache = ttf.forward_prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]))
    assert got.shape == (B, jcfg.vocab) and got.dtype == torch.float32
    _close(got, want, F32_TOL)
    for name in ("k", "v"):
        _close(cache["pos0"][name], jcache["pos0"][name], F32_TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_steps_match_reference(arch, impl):
    """Prefill S tokens into a cache of S + STEPS positions, then decode
    STEPS tokens; the reference's cache is padded the same way."""
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch, impl, seed=1)
    _, jcache = jtf.forward_prefill(jcfg, jparams, jnp.asarray(tokens[:, :S]))
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape[:2] + (S + STEPS,) + a.shape[3:], a.dtype)
        .at[:, :, :S].set(a), jcache)
    _, cache = ttf.forward_prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]),
                                   max_seq=S + STEPS)
    for name in ("k", "v"):
        _close(cache["pos0"][name], jcache["pos0"][name], F32_TOL)
    for t in range(S, S + STEPS):
        want, jcache = jtf.forward_decode(jcfg, jparams, jnp.asarray(tokens[:, t]), jcache, t)
        got, cache2 = ttf.forward_decode(tcfg, tparams, torch.from_numpy(tokens[:, t]), cache, t)
        assert cache2 is cache  # updated in place
        _close(got, want, F32_TOL)
    for name in ("k", "v"):
        _close(cache["pos0"][name], jcache["pos0"][name], F32_TOL)


def test_decode_continues_a_carried_cache():
    """A reference cache carried over by ``lm_cache_from_numpy`` decodes to
    the reference's logits."""
    jcfg, tcfg, jparams, tparams, tokens = _setup("llama3.2-3b", "xla", seed=2)
    _, jcache = jtf.forward_prefill(jcfg, jparams, jnp.asarray(tokens[:, :S]))
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape[:2] + (S + 1,) + a.shape[3:], a.dtype).at[:, :, :S].set(a),
        jcache)
    cache = lm_cache_from_numpy(tcfg, _np_tree(jcache), device="cpu")
    want, _ = jtf.forward_decode(jcfg, jparams, jnp.asarray(tokens[:, S]), jcache, S)
    got, _ = ttf.forward_decode(tcfg, tparams, torch.from_numpy(tokens[:, S]), cache, S)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_prefill_and_decode_match_reference(arch):
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch, "flash", bf16=True, seed=3)
    want, jcache = jtf.forward_prefill(jcfg, jparams, jnp.asarray(tokens[:, :S]))
    got, cache = ttf.forward_prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]),
                                     max_seq=S + 1)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape[:2] + (S + 1,) + a.shape[3:], a.dtype).at[:, :, :S].set(a),
        jcache)
    want, _ = jtf.forward_decode(jcfg, jparams, jnp.asarray(tokens[:, S]), jcache, S)
    got, _ = ttf.forward_decode(tcfg, tparams, torch.from_numpy(tokens[:, S]), cache, S)
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_layout_matches_reference(arch, reduced):
    """Keys, shapes and dtypes of the port's ``init_params`` (on the meta
    device: nothing is allocated) against the reference's
    ``abstract_params``; and the same parameter count."""
    jmod, tmod = ARCHS[arch]
    jcfg = jmod.reduced_config() if reduced else jmod.config()
    tcfg = tmod.reduced_config() if reduced else tmod.config()
    want = jtf.abstract_params(jcfg)
    got = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="meta")
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.param_count() == sum(g.numel() for _, g in got_leaves)


def test_init_params_values():
    """Norms are ones, projections N(0, 0.02^2), drawn from the generator."""
    cfg = llama3_2_3b.reduced_config()
    a = ttf.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = ttf.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(a["blocks"]["pos0"]["wq"], b["blocks"]["pos0"]["wq"])
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
    assert abs(float(a["embed"].std()) - 0.02) < 0.002


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_converter_round_trip(bf16):
    jcfg, tcfg = _configs("smollm-135m", "xla", bf16)
    tree = _np_tree(jtf.init_params(jcfg, jax.random.PRNGKey(4)))
    params = lm_params_from_numpy(tcfg, tree, device="cpu")
    assert "lm_head" not in params  # tied embeddings
    for (path, t), (_, a) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                 jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert t.dtype == tcfg.param_dtype, path
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))


def test_converter_rejects_other_layouts():
    jcfg, tcfg = _configs("llama3.2-3b", "xla")
    tree = _np_tree(jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    tree["blocks"]["pos0"]["wq"] = tree["blocks"]["pos0"]["wq"][:, :, :1]
    with pytest.raises(ValueError, match="wq"):
        lm_params_from_numpy(tcfg, tree, device="cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(tcfg, tree, device="cpu")


def test_unported_layers_raise():
    """Only an unknown ``attention_impl`` is refused now: expert
    parallelism (``ep_mesh``, ROADMAP A12.2b) builds at the global shapes
    (a rank takes its blocks with ``dist.step.shard_tree``), and MoE and
    chunked-local layers build."""
    cfg = llama3_2_3b.reduced_config()
    ep = dataclasses.replace(cfg, moe=ttf.MoEConfig(n_experts=4), ep_mesh=object())
    assert ttf.init_params(ep, torch.Generator(), device="cpu")["blocks"]["pos0"][
        "we_gate"].shape == (cfg.n_groups, 4, cfg.d_model, cfg.d_ff)
    assert ttf.init_cache(ep, 1, 4, device="cpu")["pos0"]["k"].shape[:3] == (
        cfg.n_groups, 1, 4)
    moe_local = dataclasses.replace(cfg, moe=ttf.MoEConfig(n_experts=4), period=4,
                                    local_positions=(0, 1, 2))
    assert "router" in ttf.init_params(moe_local, torch.Generator(), device="cpu")["blocks"]["pos0"]
    with pytest.raises(ValueError, match="attention_impl"):
        ttf.init_params(dataclasses.replace(cfg, attention_impl="pallas"), torch.Generator(),
                        device="cpu")
