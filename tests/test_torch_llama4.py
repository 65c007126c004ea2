"""The port's Llama 4 (MoE, chunked-local attention) and Mistral paths
against the reference, on the CPU.

The reduced ``llama4-scout-17b-a16e`` (E = 4) and
``llama4-maverick-400b-a17b`` (E = 8) configurations: 8 layers in two
groups of [local, local, local, global], ``local_chunk`` 32.  Both packages
run on the reference's weights (``init_params``, carried over by
``lm_params_from_numpy``) and numpy-seeded tokens:

- ``forward_prefill`` at 2 x 64 tokens (two chunks on each local layer)
  under ``"flash"`` and ``"xla"``: the routing of every MoE layer first
  (each token's expert and ``keep``), then the logits and the cache;
- ``forward_decode`` across a chunk boundary (prefill 32, decode t = 32 ..
  35: at t = 32 a local layer sees only the new token), routing first;
- ``forward_train``'s loss (the auxiliary loss included) and every
  gradient leaf against ``jax.value_and_grad``;
- the layout, the converter, ``active_param_count``, the registry, the
  ``S % C`` refusal, iRoPE and the chunked view handed to flash attention;
- the reduced ``mistral-large-123b`` (dense) prefill and decode;
- ``launch.train.main`` for ``llama4-scout-17b-a16e``, 2 steps on the CPU.

The reference's routing is read by a hook on its ``_moe_ffn`` that runs
the reference's own routing lines on the layer's input
(``test_torch_moe.jax_route``) and hands them out by ``jax.debug.callback``;
the port's by a hook on ``_route``.  The reference's flash path runs its
Pallas kernel in interpret mode, the port's the kernel's plain version.

Tolerances as ``tests/test_torch_lm.py`` and
``tests/test_torch_train_lm.py``: logits and caches within 1e-5 (f32);
the loss within 1e-5 relative, each gradient leaf within 1e-5 in relative
Frobenius norm.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe import assert_same_routes, jax_route, port_route

from repro.configs import llama4_maverick_400b_a17b as jax_maverick
from repro.configs import llama4_scout_17b_a16e as jax_scout
from repro.configs import mistral_large_123b as jax_mistral
from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro_torch.configs import (
    llama4_maverick_400b_a17b, llama4_scout_17b_a16e, mistral_large_123b,
)
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention_plain, flash_route
from repro_torch.models import transformer as ttf
from repro_torch.models.common import apply_rope, rms_norm
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


LLAMA4 = {"llama4-scout-17b-a16e": (jax_scout, llama4_scout_17b_a16e),
          "llama4-maverick-400b-a17b": (jax_maverick, llama4_maverick_400b_a17b)}
ARCHS = {**LLAMA4, "mistral-large-123b": (jax_mistral, mistral_large_123b)}
IMPLS = ("flash", "xla")
F32_TOL = 1e-5
LOSS_RTOL = GRAD_RTOL = 1e-5
B, S = 2, 64
DEC_PROMPT, DEC_STEPS = 32, 4
#: both configurations and both attention paths, where four cases would
#: repeat each other (decode attention and the MoE do not read the path)
TWO_CASES = (("llama4-scout-17b-a16e", "flash"), ("llama4-maverick-400b-a17b", "xla"))

_ORIG_MOE = jtf._moe_ffn
_JAX_ROUTES = []


def _record_jax_route(top, kept, gate):
    _JAX_ROUTES.append((np.asarray(top), np.asarray(kept), np.asarray(gate)))


def _hooked_moe(cfg, p, x, capacity_factor=None):
    """The reference's ``_moe_ffn``, its routing handed out first."""
    jax.debug.callback(_record_jax_route, *jax_route(cfg, p["router"], x, capacity_factor))
    return _ORIG_MOE(cfg, p, x, capacity_factor)


@pytest.fixture
def routes(monkeypatch):
    """(port routes, reference routes), each a list of (top, kept, gate) per
    routed layer call, in call order; both emptied by ``clear()``."""
    port = []
    route = ttf._route

    def recording_route(*a):
        r = route(*a)
        port.append(port_route(r))
        return r

    monkeypatch.setattr(ttf, "_route", recording_route)
    monkeypatch.setattr(jtf, "_moe_ffn", _hooked_moe)

    class Routes:
        def clear(self):
            port.clear()
            _JAX_ROUTES.clear()

        def check(self, what):
            jax.effects_barrier()
            assert_same_routes(port, _JAX_ROUTES, what)
            self.clear()

    r = Routes()
    r.clear()
    return r


def _configs(arch, impl):
    jmod, tmod = ARCHS[arch]
    return (dataclasses.replace(jmod.reduced_config(), attention_impl=impl),
            dataclasses.replace(tmod.reduced_config(), attention_impl=impl))


_JAX = {}


def _jax_fn(kind, jcfg):
    """The reference's step, jitted once per configuration (traced under
    the routing hook)."""
    if kind == "decode":  # the reference's decode reads no attention_impl
        jcfg = dataclasses.replace(jcfg, attention_impl="xla")
    key = (kind, jcfg)
    if key not in _JAX:
        if kind == "prefill":
            _JAX[key] = jax.jit(lambda p, t: jtf.forward_prefill(jcfg, p, t))
        else:
            _JAX[key] = jax.jit(lambda p, tok, c, t: jtf.forward_decode(jcfg, p, tok, c, t))
    return _JAX[key]


def _setup(arch, impl, seed=0, n_tokens=S + DEC_STEPS):
    jcfg, tcfg = _configs(arch, impl)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab, (B, n_tokens)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _pad_cache(jcache, n):
    return jax.tree.map(lambda a: jnp.zeros(a.shape[:2] + (n,) + a.shape[3:], a.dtype)
                        .at[:, :, :a.shape[2]].set(a), jcache)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", sorted(LLAMA4))
def test_prefill_matches_reference(arch, impl, routes):
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch, impl)
    want, jcache = _jax_fn("prefill", jcfg)(jparams, jnp.asarray(tokens[:, :S]))
    got, cache = ttf.forward_prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]))
    routes.check(f"{arch} {impl} prefill")
    assert got.shape == (B, jcfg.vocab) and got.dtype == torch.float32
    _close(got, want)
    for pos in range(tcfg.period):
        for name in ("k", "v"):
            _close(cache[f"pos{pos}"][name], jcache[f"pos{pos}"][name])


@pytest.mark.parametrize("arch,impl", TWO_CASES)
def test_decode_across_a_chunk_boundary(arch, impl, routes):
    """Prefill 32 tokens (one chunk) into a cache of 36, then decode t = 32
    .. 35: the first step opens the second chunk, so the local layers
    attend only to the new positions while the global layer sees all."""
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch, impl, seed=1)
    n = DEC_PROMPT + DEC_STEPS
    _, jcache = _jax_fn("prefill", jcfg)(jparams, jnp.asarray(tokens[:, :DEC_PROMPT]))
    jcache = _pad_cache(jcache, n)
    _, cache = ttf.forward_prefill(tcfg, tparams, torch.from_numpy(tokens[:, :DEC_PROMPT]),
                                   max_seq=n)
    routes.check(f"{arch} {impl} prefill of {DEC_PROMPT}")
    decode = _jax_fn("decode", jcfg)
    for t in range(DEC_PROMPT, n):
        want, jcache = decode(jparams, jnp.asarray(tokens[:, t]), jcache, t)
        got, cache2 = ttf.forward_decode(tcfg, tparams, torch.from_numpy(tokens[:, t]), cache, t)
        assert cache2 is cache
        routes.check(f"{arch} {impl} decode t={t}")
        _close(got, want)
    for pos in range(tcfg.period):
        for name in ("k", "v"):
            _close(cache[f"pos{pos}"][name], jcache[f"pos{pos}"][name])


def test_decode_local_mask_is_the_chunk():
    """The local layers' decode at t = 32 equals attention over the new
    token alone: a cache whose first chunk is garbage gives the same
    logits as the true cache on a model whose layers are all local."""
    _, tcfg, _, tparams, tokens = _setup("llama4-scout-17b-a16e", "xla", seed=2)
    local = dataclasses.replace(tcfg, period=4, local_positions=(0, 1, 2, 3))
    n = DEC_PROMPT + 1
    _, cache = ttf.forward_prefill(local, tparams, torch.from_numpy(tokens[:, :DEC_PROMPT]),
                                   max_seq=n)
    noisy = {key: {name: c.clone() for name, c in kv.items()} for key, kv in cache.items()}
    for kv in noisy.values():
        for c in kv.values():
            c[:, :, :DEC_PROMPT].normal_(generator=torch.Generator().manual_seed(0))
    tok = torch.from_numpy(tokens[:, DEC_PROMPT])
    want, _ = ttf.forward_decode(local, tparams, tok, cache, DEC_PROMPT)
    got, _ = ttf.forward_decode(local, tparams, tok, noisy, DEC_PROMPT)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sequence_not_a_multiple_of_the_chunk():
    """S = 48 over chunks of 32: the port raises ``ValueError``, the
    reference ``AssertionError`` (ROADMAP C10)."""
    jcfg, tcfg = _configs("llama4-scout-17b-a16e", "xla")
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 48, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 48, 2, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="not a multiple of the local chunk 32"):
        ttf._chunked_local_attention(tcfg, *(torch.from_numpy(a) for a in (q, k, k)))
    with pytest.raises(AssertionError):
        jtf._chunked_local_attention(jcfg, *(jnp.asarray(a) for a in (q, k, k)))
    # a sequence shorter than the chunk is one chunk, in both
    got = ttf._chunked_local_attention(tcfg, *(torch.from_numpy(a[:, :16]) for a in (q, k, k)))
    want = jtf._chunked_local_attention(jcfg, *(jnp.asarray(a[:, :16]) for a in (q, k, k)))
    _close(got, want)


def test_local_layers_take_one_flash_call_on_the_chunked_view(monkeypatch):
    """On ``"flash"``, each layer of a prefill is one attention call: a
    local layer's on the [B * S/C, H, C, Dh] view of q, k, v (strides of
    the [B, S, H, Dh] projection: no copy), a global layer's on [B, H, S,
    Dh].  The bf16 chunked view is one the Hopper kernel takes."""
    calls = []

    def recording(q, k, v, *, causal=True):
        calls.append((tuple(q.shape), q.stride(), tuple(k.shape), flash_route(q, k, v)))
        return flash_attention_plain(q, k, v, causal=causal)

    monkeypatch.setattr(ttf, "flash_attention", recording)
    _, tcfg = _configs("llama4-scout-17b-a16e", "flash")
    tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, tcfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    ttf.forward_prefill(tcfg, params, tokens)
    H, K, Dh, C = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim, tcfg.local_chunk
    nc = S // C
    local = ((B * nc, H, C, Dh), (C * H * Dh, Dh, H * Dh, 1), (B * nc, K, C, Dh), "hopper")
    glob = ((B, H, S, Dh), (S * H * Dh, Dh, H * Dh, 1), (B, K, S, Dh), "hopper")
    assert calls == [local, local, local, glob] * tcfg.n_groups


def test_rope_only_on_local_layers():
    """iRoPE: ``_qkv`` rotates q and k on the local positions and leaves
    the global position's (NoPE) as projected."""
    _, tcfg = _configs("llama4-scout-17b-a16e", "xla")
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(1, 8, tcfg.d_model, generator=torch.Generator().manual_seed(1))
    positions = torch.arange(8)[None, :]
    for pos in range(tcfg.period):
        p = ttf._group_params(params["blocks"][f"pos{pos}"], 0)
        q, k, _ = ttf._qkv(tcfg, pos, p, x, positions)
        h = rms_norm(x, p["attn_norm"])
        q0, k0 = ttf._project(h, p["wq"]), ttf._project(h, p["wk"])
        if pos in tcfg.local_positions:
            q0, k0 = (apply_rope(a, positions, tcfg.rope_theta) for a in (q0, k0))
        assert torch.equal(q, q0) and torch.equal(k, k0), pos


@pytest.fixture(scope="module")
def train_reference():
    """The reference's loss and gradients of ``forward_train`` on 2 x 64
    tokens (one value-and-grad per configuration and attention path)."""
    out = {}
    tokens = np.random.default_rng(4).integers(0, 512, (B, S)).astype(np.int32)
    for arch, impl in TWO_CASES:
        jcfg, tcfg = _configs(arch, impl)
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(5))
        tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        loss, grads = jax.value_and_grad(
            lambda p, c=jcfg: jtf.forward_train(c, p, jnp.asarray(tokens), jnp.asarray(tokens))
        )(jparams)
        paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(grads)[0]]
        out[arch, impl] = dict(tcfg=tcfg, tparams=tparams, loss=float(loss), paths=paths,
                               grads=[np.asarray(g) for g in jax.tree.leaves(grads)])
    out["tokens"] = tokens
    return out


@pytest.mark.parametrize("arch,impl", TWO_CASES)
def test_forward_train_matches_reference(train_reference, arch, impl):
    ref = train_reference[arch, impl]
    cfg = ref["tcfg"]
    t = torch.from_numpy(train_reference["tokens"])
    loss, grads = value_and_grad(lambda p, b: ttf.forward_train(cfg, p, t, t), ref["tparams"],
                                 None)
    assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    # the auxiliary loss is in it (each layer's is near 1 at these weights)
    with torch.no_grad():
        x, aux = ref["tparams"]["embed"][t], 0.0
        for g in range(cfg.n_groups):
            block = {k: ttf._group_params(b, g) for k, b in ref["tparams"]["blocks"].items()}
            x, aux = ttf._remat_group(cfg, block, x, aux)
    assert float(aux) > 0.5 * cfg.n_layers
    leaves, paths = flatten(grads)
    assert ["".join(f"['{k}']" for k in p) for p in paths] == ref["paths"]
    for path, got, want in zip(paths, leaves, ref["grads"]):
        assert got.shape == want.shape, path
        assert _rel(got.numpy(), want) <= GRAD_RTOL, (path, _rel(got.numpy(), want))
    routed = [p for p, g in zip(paths, leaves) if p[-1] in ("router", "we_gate", "ws_gate")]
    assert len(routed) == 3 * cfg.period and all(
        float(g.abs().max()) > 0 for p, g in zip(paths, leaves) if p in routed)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_layout_matches_reference(arch, reduced):
    """Keys, shapes and dtypes of ``init_params`` (meta device) against the
    reference's ``abstract_params``; ``param_count`` and
    ``active_param_count`` equal the reference's."""
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
    assert tcfg.param_count() == jcfg.param_count() == sum(g.numel() for _, g in got_leaves)
    assert tcfg.active_param_count() == jcfg.active_param_count()
    if tcfg.moe:
        assert tcfg.active_param_count() < tcfg.param_count()
        assert "w_gate" not in got["blocks"]["pos0"] and "ws_down" in got["blocks"]["pos3"]


def test_converter_carries_and_checks_the_expert_keys():
    jcfg, tcfg = _configs("llama4-maverick-400b-a17b", "xla")
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(6)))
    params = lm_params_from_numpy(tcfg, tree, device="cpu")
    for pos in range(tcfg.period):
        for name in ("router", "we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down"):
            np.testing.assert_array_equal(params["blocks"][f"pos{pos}"][name].numpy(),
                                          tree["blocks"][f"pos{pos}"][name])
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["pos1"]["we_gate"] = bad["blocks"]["pos1"]["we_gate"][:, :4]
    with pytest.raises(ValueError, match="pos1/we_gate"):
        lm_params_from_numpy(tcfg, bad, device="cpu")
    del tree["blocks"]["pos2"]["we_up"]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(tcfg, tree, device="cpu")


def test_mistral_prefill_and_decode_match_reference():
    """The dense path at Mistral's reduced shape (its flash path is the
    dense models' of ``tests/test_torch_lm.py``)."""
    jcfg, tcfg, jparams, tparams, tokens = _setup("mistral-large-123b", "xla", seed=7)
    want, jcache = _jax_fn("prefill", jcfg)(jparams, jnp.asarray(tokens[:, :S]))
    got, cache = ttf.forward_prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]),
                                     max_seq=S + 2)
    _close(got, want)
    jcache = _pad_cache(jcache, S + 2)
    for t in range(S, S + 2):
        want, jcache = _jax_fn("decode", jcfg)(jparams, jnp.asarray(tokens[:, t]), jcache, t)
        got, cache = ttf.forward_decode(tcfg, tparams, torch.from_numpy(tokens[:, t]), cache, t)
        _close(got, want)


def test_registry_returns_the_new_configs():
    """``get_arch_module`` returns both Llama 4 configs and Mistral, with
    the reference's fields (torch dtypes for jnp ones)."""
    for arch in ARCHS:
        mod, jmod = treg.get_arch_module(arch), jreg.get_arch_module(arch)
        assert (mod.ARCH_ID, mod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY) == (arch, "lm")
        assert getattr(mod, "OPT_MOMENT_DTYPE", None) == getattr(jmod, "OPT_MOMENT_DTYPE", None)
        for make in ("config", "reduced_config"):
            got, want = getattr(mod, make)(), getattr(jmod, make)()
            for f in dataclasses.fields(want):
                g, w = getattr(got, f.name), getattr(want, f.name)
                if f.name in ("param_dtype", "act_dtype"):
                    assert str(g).removeprefix("torch.") == jnp.dtype(w).name
                elif f.name == "moe":
                    assert (g is None) == (w is None)
                    assert g is None or dataclasses.asdict(g) == dataclasses.asdict(w)
                else:
                    assert g == w, (arch, make, f.name)


def test_expert_parallelism_names_its_item(monkeypatch):
    """Expert parallelism is ported (ROADMAP A12.2b): with ``ep_mesh`` set
    every MoE layer of ``forward_train`` goes through ``_moe_ffn_ep``
    (``tests/test_torch_ep.py`` runs it over ranks; here a stand-in that
    records the call and dispatches locally)."""
    cfg = dataclasses.replace(llama4_scout_17b_a16e.reduced_config(), ep_mesh=object())
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = []

    def ep_ffn(c, p, x, capacity_factor=None):
        calls.append(x.shape)
        return ttf._moe_ffn(c, p, x, capacity_factor)

    monkeypatch.setattr(ttf, "_moe_ffn_ep", ep_ffn)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator().manual_seed(1))
    local = dataclasses.replace(cfg, ep_mesh=None)
    with torch.no_grad():
        got = ttf.forward_train(cfg, params, tokens, tokens)
        want = ttf.forward_train(local, params, tokens, tokens)
    assert len(calls) == cfg.n_layers and torch.equal(got, want)


def test_training_cli_trains_scout_on_the_cpu(tmp_path):
    from repro_torch.launch.train import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--arch", "llama4-scout-17b-a16e", "--steps", "2", "--batch", "2", "--seq", "64",
              "--device", "cpu", "--ckpt", str(tmp_path)])
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith("[llama4-scout-17b-a16e] steps=2 loss ") and "restarts=0" in line
