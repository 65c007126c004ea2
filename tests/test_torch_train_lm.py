"""The port's LM training step against the reference, on the CPU.

``forward_train``'s loss and every gradient leaf against
``jax.value_and_grad`` of ``repro.models.transformer.forward_train`` on
the reduced ``smollm-135m`` configuration (tied head), under both attention
paths, on the reference's weights carried over by ``lm_params_from_numpy``
and numpy-seeded tokens (B 2, S 128).  The reference's flash path runs its
Pallas kernel in interpret mode with its custom VJP; the port's runs
``_FlashFunction`` (the plain forward on CPU tensors, ``flash_attention_vjp``
backward), which these tests force and count: on the card the same
Function wraps the kernel, held to the ``"xla"`` path by ``chip_smoke.py``
phase 10.

Tolerances (all f32):
- loss within 1e-5 relative, each gradient leaf within 1e-5 in relative
  Frobenius norm (measured: 8e-8 and at most 7.5e-7; summation order);
- ``_chunked_xent`` and its gradients within 1e-6 relative;
- the Function's dq/dk/dv within 2e-5, the existing flash tests' f32
  tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as jax_smollm
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import transformer as jtf
from repro_torch.configs import smollm_135m
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import transformer as ttf
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


IMPLS = ("xla", "flash")
B, S = 2, 128
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
XENT_RTOL = 1e-6
FLASH_TOL = 2e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def reference():
    """Per attention path: the configs, both packages' weights, the tokens
    and the reference's loss and gradients (one value-and-grad each)."""
    out = {}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    for impl in IMPLS:
        jcfg = dataclasses.replace(jax_smollm.reduced_config(), attention_impl=impl)
        tcfg = dataclasses.replace(smollm_135m.reduced_config(), attention_impl=impl)
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        loss, grads = jax.value_and_grad(
            lambda p: jtf.forward_train(jcfg, p, jnp.asarray(tokens), jnp.asarray(tokens))
        )(jparams)
        paths = [jax.tree_util.keystr(k)
                 for k, _ in jax.tree_util.tree_flatten_with_path(grads)[0]]
        out[impl] = dict(tcfg=tcfg, tparams=tparams, loss=float(loss), paths=paths,
                         grads=[np.asarray(g) for g in jax.tree.leaves(grads)])
    out["tokens"] = tokens
    return out


@pytest.fixture
def counted_flash(monkeypatch):
    """Counts the flash Function's forwards and backwards."""
    counts = {"forward": 0, "vjp": 0}
    forward, vjp = tfa._forward, tfa.flash_attention_vjp

    def counting_forward(*a, **kw):
        counts["forward"] += 1
        return forward(*a, **kw)

    def counting_vjp(*a, **kw):
        counts["vjp"] += 1
        return vjp(*a, **kw)

    monkeypatch.setattr(tfa, "_forward", counting_forward)
    monkeypatch.setattr(tfa, "flash_attention_vjp", counting_vjp)
    return counts


def _port_value_and_grad(cfg, params, tokens):
    """The training loop's value-and-grad: (loss, gradient leaves, paths)."""
    t = torch.from_numpy(tokens)
    loss, grads = value_and_grad(lambda p, b: ttf.forward_train(cfg, p, t, t), params, None)
    leaves, paths = flatten(grads)
    return loss, leaves, paths


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_train_matches_reference(reference, counted_flash, impl):
    ref = reference[impl]
    cfg = ref["tcfg"]
    loss, grads, paths = _port_value_and_grad(cfg, ref["tparams"], reference["tokens"])
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    # the leaves in jax.tree.flatten's order, path for path
    assert ["".join(f"['{k}']" for k in p) for p in paths] == ref["paths"]
    for path, got, want in zip(paths, grads, ref["grads"]):
        assert got.shape == want.shape, path
        assert _rel(got.numpy(), want) <= GRAD_RTOL, (path, _rel(got.numpy(), want))
    # remat: every layer's attention runs in the forward and again in the
    # backward; the flash path differentiates through the Function's VJP
    if impl == "flash":
        assert counted_flash == {"forward": 2 * cfg.n_layers, "vjp": cfg.n_layers}
    else:
        assert counted_flash == {"forward": 0, "vjp": 0}


def test_attention_weights_get_gradients_through_flash(reference):
    """The trap of an output without grad_fn: with flash attention, wq, wk
    and wv must receive the attention's gradient, the same as "xla"."""
    cfg = reference["flash"]["tcfg"]
    _, flash, paths = _port_value_and_grad(cfg, reference["flash"]["tparams"],
                                           reference["tokens"])
    xcfg = dataclasses.replace(cfg, attention_impl="xla")
    _, xla, _ = _port_value_and_grad(xcfg, reference["flash"]["tparams"], reference["tokens"])
    for path, f, x in zip(paths, flash, xla):
        if path[-1] in ("wq", "wk", "wv"):
            assert float(f.abs().max()) > 0, path
            assert _rel(f.numpy(), x.numpy()) <= GRAD_RTOL, path


def _xent_inputs(seq, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, seq, 64)).astype(np.float32)
    embed = (rng.standard_normal((512, 64)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 512, (2, seq)).astype(np.int32)
    return x, embed, labels


def test_chunked_xent_ragged_last_chunk():
    """S 20 in chunks of 8: two full chunks and a ragged one of 4."""
    x, embed, labels = _xent_inputs(20, 1)
    head = np.ascontiguousarray(embed.T)
    jcfg, tcfg = jax_smollm.reduced_config(), smollm_135m.reduced_config()
    want, (wdx, wdh) = jax.value_and_grad(
        lambda a, h: jtf._chunked_xent(jcfg, a, h, jnp.asarray(labels), chunk=8),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    loss = ttf._chunked_xent(tcfg, tx, th, torch.from_numpy(labels), chunk=8)
    dx, dh = torch.autograd.grad(loss, (tx, th))
    got = float(loss.detach())
    assert abs(got - float(want)) <= XENT_RTOL * abs(float(want))
    assert _rel(dx.numpy(), wdx) <= XENT_RTOL and _rel(dh.numpy(), wdh) <= XENT_RTOL
    # the mean over every position: one chunk of 20 gives the same loss
    with torch.no_grad():
        whole = float(ttf._chunked_xent(tcfg, tx, th, torch.from_numpy(labels), chunk=512))
    assert abs(whole - got) <= XENT_RTOL * abs(got)


def test_tied_head_gradient():
    """The tied head is embed.T cast to the activation dtype: the gradient
    reaching ``embed`` through it equals the reference's."""
    x, embed, labels = _xent_inputs(24, 2)
    jcfg, tcfg = jax_smollm.reduced_config(), smollm_135m.reduced_config()
    want = jax.grad(lambda e: jtf._chunked_xent(jcfg, jnp.asarray(x), e.T,
                                                jnp.asarray(labels), chunk=16))(
        jnp.asarray(embed))
    te = torch.from_numpy(embed).requires_grad_(True)
    head = ttf._head(tcfg, {"embed": te})
    loss = ttf._chunked_xent(tcfg, torch.from_numpy(x), head, torch.from_numpy(labels), chunk=16)
    (got,) = torch.autograd.grad(loss, (te,))
    assert _rel(got.numpy(), want) <= XENT_RTOL


FLASH_CASES = {
    # (B, H, H_kv, S_q, S_kv, Dh, causal)
    "gqa-causal": (2, 4, 2, 128, 128, 32, True),
    "gqa-full": (1, 6, 2, 64, 64, 16, False),
    "mha-causal-kv-longer": (1, 2, 2, 64, 128, 16, True),
}


@pytest.mark.parametrize("q_block", (1024, 32))
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_function_vjp_matches_reference(case, q_block):
    """dq/dk/dv of the port's Function (blockwise VJP at ``q_block``)
    against ``jax.vjp`` of the reference's ``flash_attention_pallas``
    (interpret mode, custom VJP), with GQA's KV heads repeated before the
    reference kernel as ``_gqa_attention`` does."""
    Bq, H, H_kv, S_q, S_kv, Dh, causal = FLASH_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((Bq, H, S_q, Dh)).astype(np.float32)
    k = rng.standard_normal((Bq, H_kv, S_kv, Dh)).astype(np.float32)
    v = rng.standard_normal((Bq, H_kv, S_kv, Dh)).astype(np.float32)
    g = rng.standard_normal((Bq, H, S_q, Dh)).astype(np.float32)
    rep = H // H_kv

    def ref(a, b, c):
        return flash_attention_pallas(a, jnp.repeat(b, rep, axis=1), jnp.repeat(c, rep, axis=1),
                                      causal=causal, block_q=min(128, S_q),
                                      block_k=min(128, S_kv), interpret=True)

    want_out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None and "FlashFunction" in type(out.grad_fn).__name__
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=FLASH_TOL, atol=FLASH_TOL)
    got = tfa.flash_attention_vjp(tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(g),
                                  causal=causal, q_block=q_block)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b, w in zip("qkv", got, auto, want):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=FLASH_TOL, atol=FLASH_TOL,
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(b.numpy(), np.asarray(w), rtol=FLASH_TOL, atol=FLASH_TOL,
                                   err_msg=f"d{name} through autograd")


def test_flash_function_only_where_a_gradient_is_wanted():
    """No grad mode or no operand requiring grad: the plain forward, no
    graph; one operand requiring grad: the Function."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 8)).astype(np.float32))
               for _ in range(3))
    assert tfa.flash_attention(q, k, v).grad_fn is None
    kk = k.clone().requires_grad_(True)
    with torch.no_grad():
        assert tfa.flash_attention(q, kk, v).grad_fn is None
    out = tfa.flash_attention(q, kk, v)
    assert "FlashFunction" in type(out.grad_fn).__name__
    (dk,) = torch.autograd.grad(out.sum(), (kk,))
    want = torch.autograd.grad(tfa.flash_attention_plain(q, kk, v).sum(), (kk,))[0]
    torch.testing.assert_close(dk, want, rtol=FLASH_TOL, atol=FLASH_TOL)


def test_flash_vjp_rejects_a_wrong_gradient_shape():
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="gradient"):
        tfa.flash_attention_vjp(q, q, q, torch.zeros(1, 2, 7, 4))


def _raises_without_cuda(fn):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()


@pytest.mark.parametrize("entry", ("train", "launch", "init_params", "restore_meta"))
def test_training_entry_points_default_to_the_card(entry, tmp_path):
    """Without a card, every training entry point raises at its default
    device instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.launch.train import main
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.loop import train

    cfg = smollm_135m.reduced_config()
    if entry == "train":
        _raises_without_cuda(lambda: train(
            lambda p, b: p["w"].sum(), lambda: {"w": torch.ones(2)}, lambda s: {},
            n_steps=1, ckpt_dir=str(tmp_path)))
    elif entry == "launch":
        _raises_without_cuda(lambda: main(["--arch", "smollm-135m", "--steps", "1",
                                           "--ckpt", str(tmp_path)]))
    elif entry == "init_params":
        _raises_without_cuda(lambda: ttf.init_params(cfg, torch.Generator()))
    else:
        path = save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
        like = {"w": torch.empty(3, device="meta")}
        _raises_without_cuda(lambda: restore_checkpoint(path, like))
        restored, _ = restore_checkpoint(path, like, device="cpu")
        assert torch.equal(restored["w"], torch.ones(3))
