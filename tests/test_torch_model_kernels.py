"""The port's flash-attention and embedding-bag plain versions against the
reference's Pallas kernels (interpret mode) and its oracles, on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against these plain versions there); on CPU tensors the wrappers run
the plain versions and count no launch.

Tolerances are the reference's own kernel tests' (``tests/test_kernels.py``):
flash attention 2e-5 in f32 and 2e-2 in bf16, embedding bag 1e-6 in f32 and
3e-2 in bf16 (the reference sums bf16 rows in bf16, the port in f32 with one
rounding at the end).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.embedding_bag import csr_to_padded as jax_csr_to_padded
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.convert import _float_tensor
from repro_torch.kernels.embedding_bag import (
    csr_to_padded, embedding_bag, embedding_bag_plain,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}
BAG_TOL = {"f32": 1e-6, "bf16": 3e-2}


def _both(x, dtype):
    """The same numbers as a JAX array and a CPU tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(x, jdt)
    return j, _float_tensor(np.asarray(j), tdt, "cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _qkv(rng, B, H, H_kv, S_q, S_kv, Dh, dtype):
    q = _both(rng.standard_normal((B, H, S_q, Dh)) * 0.5, dtype)
    k = _both(rng.standard_normal((B, H_kv, S_kv, Dh)) * 0.5, dtype)
    v = _both(rng.standard_normal((B, H_kv, S_kv, Dh)) * 0.5, dtype)
    return q, k, v


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,S,Dh", [(2, 2, 128, 32), (1, 3, 64, 16)])
def test_flash_plain_matches_pallas_and_ref(dtype, causal, B, H, S, Dh):
    rng = np.random.default_rng(1000 * S + Dh)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, B, H, H, S, S, Dh, dtype)
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                                    interpret=True)
    _close(got, pallas, FLASH_TOL[dtype])
    _close(got, ref.flash_attention_ref(jq, jk, jv, causal=causal), FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_kv_window(dtype):
    """S_kv > S_q (a prefill or decode window over a cache): query i sees
    keys <= i + S_kv - S_q."""
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 2, 2, 64, 256, 32, dtype)
    got = flash_attention_plain(tq, tk, tv, causal=True)
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, block_q=32, block_k=64,
                                    interpret=True)
    _close(got, pallas, FLASH_TOL[dtype])
    _close(got, ref.flash_attention_ref(jq, jk, jv, causal=True), FLASH_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_gqa_is_the_repeated_heads(causal):
    """H_kv < H: query head h reads KV head h // (H / H_kv), as the
    reference's ``jnp.repeat`` over the KV heads gives."""
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 6, 2, 64, 96, 16, "f32")
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    want = ref.flash_attention_ref(jq, jnp.repeat(jk, 3, axis=1), jnp.repeat(jv, 3, axis=1),
                                   causal=causal)
    _close(got, want, FLASH_TOL["f32"])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_shape_is_served(causal):
    """S = 200 is no multiple of the reference's block: its wrapper hands it
    to the plain reference, the port's wrapper to its own version (on the
    card, to the kernel)."""
    rng = np.random.default_rng(200)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 2, 2, 200, 200, 32, "f32")
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    before = flash_attention.launches
    _close(flash_attention(tq, tk, tv, causal=causal), want, FLASH_TOL["f32"])
    _close(flash_attention_plain(tq, tk, tv, causal=causal, q_block=64), want,
           FLASH_TOL["f32"])
    assert flash_attention.launches == before  # CPU tensors: no launch


def test_flash_strided_views_match_contiguous():
    """The model hands [B, S, H, Dh] activations seen as [B, H, S, Dh]."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g)
    k = torch.randn(2, 40, 2, 16, generator=g)
    v = torch.randn(2, 40, 2, 16, generator=g)
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = flash_attention_plain(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                                 v.transpose(1, 2).contiguous())
    assert torch.equal(got, want)


def test_flash_causal_short_kv_raises():
    q = torch.zeros(1, 2, 64, 16)
    kv = torch.zeros(1, 2, 32, 16)
    for fn in (flash_attention, flash_attention_plain):
        with pytest.raises(ValueError, match="S_kv >= S_q"):
            fn(q, kv, kv, causal=True)
    assert flash_attention(q, kv, kv, causal=False).shape == q.shape


def test_flash_rejects_mismatched_heads():
    q = torch.zeros(1, 3, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="heads"):
        flash_attention(q, kv, kv)


# ---------------------------------------------------------------------------
# embedding bag
# ---------------------------------------------------------------------------


def _bags(rng, V, B, L, empty_rows=()):
    lens = rng.integers(1, L + 1, B)
    for r in empty_rows:
        lens[r] = 0
    indices = np.concatenate([rng.integers(0, V, n) for n in lens]).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return indices, offsets


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,D,B,L", [(100, 16, 37, 4), (1000, 64, 128, 1), (50, 8, 5, 7)])
def test_embedding_bag_plain_matches_pallas_and_ref(dtype, mode, V, D, B, L):
    rng = np.random.default_rng(V + D + B + L)
    jt, tt = _both(rng.standard_normal((V, D)), dtype)
    indices, offsets = _bags(rng, V, B, L)
    padded = jax_csr_to_padded(indices, offsets, L)
    got = embedding_bag_plain(tt, torch.from_numpy(padded), mode=mode)
    assert got.dtype == tt.dtype and got.shape == (B, D)
    pallas = embedding_bag_pallas(jt, jnp.asarray(padded), mode=mode, block_b=32,
                                  interpret=True)
    want = ref.embedding_bag_ref(jt.astype(jnp.float32), jnp.asarray(indices),
                                 jnp.asarray(offsets), mode)
    _close(got, pallas, BAG_TOL[dtype])
    _close(got, want, BAG_TOL[dtype])
    assert torch.equal(embedding_bag(tt, torch.from_numpy(padded), mode=mode), got)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_empty_and_single_bags(mode):
    """All-padding bags give zeros under both modes; a bag of one row is
    that row."""
    rng = np.random.default_rng(5)
    jt, tt = _both(rng.standard_normal((30, 8)), "f32")
    indices, offsets = _bags(rng, 30, 9, 5, empty_rows=(0, 4, 8))
    padded = jax_csr_to_padded(indices, offsets, 5)
    padded[2, 1:] = -1
    got = embedding_bag_plain(tt, torch.from_numpy(padded), mode=mode)
    assert torch.equal(got[[0, 4, 8]], torch.zeros(3, 8))
    assert torch.equal(got[2], tt[padded[2, 0]])
    pallas = embedding_bag_pallas(jt, jnp.asarray(padded), mode=mode, block_b=8,
                                  interpret=True)
    _close(got, pallas, BAG_TOL["f32"])
    none = embedding_bag_plain(tt, torch.zeros(3, 0, dtype=torch.int32), mode=mode)
    assert torch.equal(none, torch.zeros(3, 8))


@pytest.mark.parametrize("max_len", [1, 3, 6])
def test_csr_to_padded_matches_reference(max_len):
    """Including empty bags and bags cut to ``max_len``."""
    rng = np.random.default_rng(max_len)
    indices, offsets = _bags(rng, 40, 11, 6, empty_rows=(3,))
    got = csr_to_padded(indices, offsets, max_len)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_csr_to_padded(indices, offsets, max_len))


def test_embedding_bag_rejects_unknown_mode():
    for fn in (embedding_bag, embedding_bag_plain):
        with pytest.raises(ValueError, match="mode"):
            fn(torch.zeros(3, 2), torch.zeros(1, 1, dtype=torch.int32), mode="max")
