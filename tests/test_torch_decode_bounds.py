"""``forward_decode`` at a position outside the cache (ROADMAP C, known
divergence C11), on the reduced ``smollm-135m`` with ``attention_impl
"xla"`` on the CPU, after 2 x 8 prefilled tokens into a cache of exactly 8
positions (the reference's ``forward_prefill`` always returns S
positions).

The reference's ``jax.lax.dynamic_update_slice`` clamps the write into the
cache: at t = 8 the new token's k/v land on slot 7, silently overwriting
the last prompt token's.  At t = -1 it wraps the index (its negative-index
normalization) and overwrites slot 7 too, while its mask (keys at
positions <= t) admits no key.  It answers finite logits either way.  The
port refuses both before any write: ``ValueError`` naming t and the cache
length, the cache left bit for bit as it was.  At the last slot of a longer
cache both decode, and agree within 1e-5 (f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as jax_smollm
from repro.models import transformer as jtf
from repro_torch.configs import smollm_135m
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as ttf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, S = 2, 8
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(jax_smollm.reduced_config(), attention_impl="xla")
    tcfg = dataclasses.replace(smollm_135m.reduced_config(), attention_impl="xla")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (B, S + 1)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


@pytest.fixture(scope="module")
def prefilled(lm):
    jcfg, _, jparams, _, tokens = lm
    return jtf.forward_prefill(jcfg, jparams, jnp.asarray(tokens[:, :S]))[1]


@pytest.mark.parametrize("t, slot", ((8, 7), (-1, 7)), ids=("past-the-end", "negative"))
def test_reference_clamps_the_write(lm, prefilled, t, slot):
    jcfg, _, jparams, _, tokens = lm
    logits, cache = jtf.forward_decode(jcfg, jparams, jnp.asarray(tokens[:, S]), prefilled, t)
    assert logits.shape == (B, jcfg.vocab) and np.isfinite(np.asarray(logits)).all()
    for name in ("k", "v"):
        before, after = np.asarray(prefilled["pos0"][name]), np.asarray(cache["pos0"][name])
        assert after.shape[2] == S
        changed = [s for s in range(S) if not np.array_equal(after[:, :, s], before[:, :, s])]
        assert changed == [slot], (name, changed)


@pytest.mark.parametrize("t", (8, 11, -1))
def test_port_refuses_a_position_outside_the_cache(lm, t):
    _, tcfg, _, tparams, tokens = lm
    _, cache = ttf.forward_prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]))
    assert cache["pos0"]["k"].shape[2] == S
    saved = {key: {name: c.clone() for name, c in kv.items()} for key, kv in cache.items()}
    with pytest.raises(ValueError, match=rf"t={t} is outside the cache of {S} positions"):
        ttf.forward_decode(tcfg, tparams, torch.from_numpy(tokens[:, S]), cache, t)
    for key, kv in cache.items():
        for name, c in kv.items():
            assert torch.equal(c, saved[key][name]), (key, name)


def test_last_slot_of_a_longer_cache_still_decodes(lm, prefilled):
    jcfg, tcfg, jparams, tparams, tokens = lm
    jcache = jax.tree.map(
        lambda a: jnp.zeros(a.shape[:2] + (S + 1,) + a.shape[3:], a.dtype).at[:, :, :S].set(a),
        prefilled)
    _, cache = ttf.forward_prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]),
                                   max_seq=S + 1)
    want, _ = jtf.forward_decode(jcfg, jparams, jnp.asarray(tokens[:, S]), jcache, S)
    got, _ = ttf.forward_decode(tcfg, tparams, torch.from_numpy(tokens[:, S]), cache, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
