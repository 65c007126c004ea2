"""Port parity: bitvectors, wavelet matrix and sparse-table RMQ.

Structures are built by both packages from the same numpy input; the
arrays (bit words viewed as int32) and the query answers must be equal,
dtype included."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.succinct import bitvector as jbv
from repro.succinct import rmq as jrmq
from repro.succinct import wavelet as jwm
from repro_torch.succinct import bitvector as tbv
from repro_torch.succinct import rmq as trmq
from repro_torch.succinct import wavelet as twm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _np(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _same(a, b):
    a = _np(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


@pytest.mark.parametrize("n,density", [(1, 0.5), (31, 0.3), (32, 0.5), (200, 0.1), (257, 0.9)])
def test_plain_bitvector(n, density):
    bits = (np.random.default_rng(n).random(n) < density).astype(np.uint8)
    jb = jbv.plain_from_bits(bits)
    tb = tbv.plain_from_bits(torch.from_numpy(bits))
    _same(jb.words, tb.words)
    _same(jb.ones_prefix, tb.ones_prefix)
    _same(jb.zeros_prefix, tb.zeros_prefix)
    assert (jb.n, jb.m) == (tb.n, tb.m)
    i = np.arange(n + 1, dtype=np.int32)
    _same(jb.rank1(jnp.asarray(i)), tb.rank1(_t(i)))
    _same(jb.get(jnp.asarray(i[:-1])), tb.get(_t(i[:-1])))
    j = np.arange(-1, jb.m + 2, dtype=np.int32)
    _same(jax.vmap(jb.select1)(jnp.asarray(j)), tb.select1(_t(j)))
    assert jb.modeled_bits() == tb.modeled_bits()


@pytest.mark.parametrize("n,m", [(10, 0), (100, 7), (1000, 300)])
def test_sparse_bitvector(n, m):
    pos = np.sort(np.random.default_rng(m).choice(n, m, replace=False)).astype(np.int32)
    jb = jbv.sparse_from_positions(pos, n)
    tb = tbv.sparse_from_positions(torch.from_numpy(pos), n)
    _same(jb.pos, tb.pos)
    assert (jb.n, jb.m) == (tb.n, tb.m)
    i = np.arange(n + 1, dtype=np.int32)
    _same(jb.rank1(jnp.asarray(i)), tb.rank1(_t(i)))
    _same(jb.get(jnp.asarray(i[:-1])), tb.get(_t(i[:-1])))
    j = np.arange(-1, m + 2, dtype=np.int32)
    _same(jb.select1(jnp.asarray(j)), tb.select1(_t(j)))
    assert jb.modeled_bits() == tb.modeled_bits()


@pytest.mark.parametrize("sigma,n", [(2, 1), (2, 100), (5, 333), (37, 500), (300, 64)])
def test_wavelet_matrix(sigma, n):
    rng = np.random.default_rng(sigma * 7 + n)
    seq = rng.integers(0, sigma, n).astype(np.int32)
    jw = jwm.wm_build(seq, sigma)
    tw = twm.wm_build(torch.from_numpy(seq), sigma)
    for f in ("words", "ones_prefix", "zcount", "sym_starts"):
        _same(getattr(jw, f), getattr(tw, f))
    assert (jw.n, jw.sigma, jw.levels) == (tw.n, tw.sigma, tw.levels)

    Q = 64
    c = rng.integers(0, sigma, Q).astype(np.int32)
    a = rng.integers(0, n + 1, Q).astype(np.int32)
    b = rng.integers(0, n + 1, Q).astype(np.int32)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    jl, jh = jwm.wm_rank_pair_batch(jw, jnp.asarray(c), jnp.asarray(lo), jnp.asarray(hi))
    tl, th = twm.wm_rank_pair_batch(tw, _t(c), _t(lo), _t(hi))
    _same(jl, tl)
    _same(jh, th)
    _same(jwm.wm_rank_batch(jw, jnp.asarray(c), jnp.asarray(hi)), twm.wm_rank(tw, _t(c), _t(hi)))
    idx = np.arange(n, dtype=np.int32)
    _same(jax.vmap(lambda i: jwm.wm_access(jw, i))(jnp.asarray(idx)),
          twm.wm_access(tw, _t(idx)))
    np.testing.assert_array_equal(twm.wm_access(tw, _t(idx)).numpy(), seq)
    assert jwm.wm_modeled_bits(jw) == twm.wm_modeled_bits(tw)


@pytest.mark.parametrize("n,vrange", [(1, 3), (17, 2), (128, 50), (1000, 5)])
def test_rmq(n, vrange):
    rng = np.random.default_rng(n + vrange)
    values = rng.integers(0, vrange, n).astype(np.int32)
    jr = jrmq.rmq_build(values)
    tr = trmq.rmq_build(torch.from_numpy(values))
    _same(jr.values, tr.values)
    _same(jr.table, tr.table)
    assert (jr.n, jr.levels) == (tr.n, tr.levels)
    a = rng.integers(0, n, 200).astype(np.int32)
    b = rng.integers(0, n, 200).astype(np.int32)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    got = trmq.rmq_query(tr, _t(lo), _t(hi))
    _same(jrmq.rmq_query(jr, jnp.asarray(lo), jnp.asarray(hi)), got)
    # and through the list-of-rows form the Sada build uses
    rows = trmq.argmin_table(torch.from_numpy(values))
    _same(got, trmq.leftmost_argmin(torch.from_numpy(values), rows, _t(lo), _t(hi)))
    for q in range(0, 200, 23):
        seg = values[lo[q] : hi[q] + 1]
        assert int(got[q]) == lo[q] + int(np.argmin(seg))
