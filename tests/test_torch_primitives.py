"""Port parity of the batched primitives: bitvector rank, sparse-table RMQ,
the wavelet rank that streams through the rank kernel, and the kernel-routed
Sada-I-D listing.

Each plain version (the CPU path of its wrapper, and the card's yardstick)
must give the integers of the reference's Pallas kernel in interpret mode
and of its ``ref`` oracle: exact equality, dtype included.  Edge rows:
positions on word boundaries (a zero-bit mask), the last position, spans of
one, inverted spans, spans that are powers of two, the whole array, and
leftmost ties.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``); their shared core is compiled for the host in
``test_torch_kernel_core.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.rank import rank_pallas
from repro.kernels.rmq import rmq_pallas
from repro.succinct import wavelet as jwm
from repro_torch.kernels import rank as trank
from repro_torch.kernels import rmq as trmq
from repro_torch.succinct import wavelet as twm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _t(a):
    return torch.from_numpy(np.array(a))


def _fields(obj):
    """Field dict of a reference index object, arrays as numpy."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _fields(v)
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# rank
# ---------------------------------------------------------------------------


def rank_case(W, Q, seed):
    """Random words, their exclusive popcount prefix and query positions
    with every word boundary case (bit 0, bit 31, the last position)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF
    pc = np.asarray([bin(int(w)).count("1") for w in words], np.int32)
    prefix = np.concatenate([[0], np.cumsum(pc)[:-1]]).astype(np.int32)
    edges = [e for e in (0, 1, 31, 32, 33, 32 * W - 1) if e < 32 * W]
    idx = np.concatenate([edges, rng.integers(0, 32 * W, Q)]).astype(np.int32)
    return words, prefix, idx


@pytest.mark.parametrize("W,Q,block_q", [(1, 3, 8), (5, 40, 16), (70, 500, 128)])
def test_rank_plain_matches_pallas(W, Q, block_q):
    words, prefix, idx = rank_case(W, Q, seed=W + Q)
    got = trank.rank_plain(_t(words.view(np.int32)), _t(prefix), _t(idx))
    _same(ref.rank_ref(jnp.asarray(words), jnp.asarray(prefix), jnp.asarray(idx)), got)
    _same(rank_pallas(jnp.asarray(words), jnp.asarray(prefix), jnp.asarray(idx),
                      block_q=block_q, interpret=True), got)
    # a host count of the ones below each position
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    ones = np.concatenate([[0], np.cumsum(bits)])
    np.testing.assert_array_equal(ones[idx], got.numpy())
    # the wrapper on CPU tensors: the plain path, no launch counted
    before = trank.rank.launches
    _same(np.asarray(got), trank.rank(_t(words.view(np.int32)), _t(prefix), _t(idx)))
    assert trank.rank.launches == before


@pytest.mark.parametrize("n,sigma,B", [(1, 2, 4), (300, 5, 64), (777, 37, 33)])
def test_wm_rank_batch_matches_reference(n, sigma, B):
    rng = np.random.default_rng(n + sigma)
    seq = rng.integers(0, sigma, n)
    jw = jwm.wm_build(seq, sigma)
    tw = twm.wm_build(torch.from_numpy(seq), sigma)
    c = rng.integers(0, sigma, B).astype(np.int32)
    i = np.concatenate([[0, n, n - 1 if n > 1 else 0, min(32, n)],
                        rng.integers(0, n + 1, B - 4)]).astype(np.int32)
    got = twm.wm_rank_batch(tw, _t(c), _t(i))
    for use_kernel in (True, False):
        _same(jwm.wm_rank_batch(jw, jnp.asarray(c), jnp.asarray(i), use_kernel=use_kernel,
                                block_q=64), got)
    np.testing.assert_array_equal(
        got.numpy(), [np.count_nonzero(seq[:p] == s) for s, p in zip(c, i)])


# ---------------------------------------------------------------------------
# RMQ
# ---------------------------------------------------------------------------


def rmq_case(rho, Q, seed, distinct_values):
    """Values (few distinct ones forces leftmost ties), their sparse table
    and query ranges with every edge: lo == hi, hi < lo, power-of-two
    spans, span = rho."""
    from repro.succinct.rmq import rmq_build

    rng = np.random.default_rng(seed)
    values = rng.integers(0, distinct_values, rho).astype(np.int32)
    table = np.asarray(rmq_build(jnp.asarray(values)).table)
    lo = rng.integers(0, rho, Q)
    hi = np.minimum(lo + rng.integers(0, rho, Q), rho - 1)
    edge_lo, edge_hi = [0, rho - 1, 0, rho - 1], [rho - 1, rho - 1, 0, 0]
    for p in range(rho.bit_length()):
        a = int(rng.integers(0, rho - (1 << p) + 1))
        edge_lo.append(a)
        edge_hi.append(a + (1 << p) - 1)
    lo = np.concatenate([edge_lo, lo]).astype(np.int32)
    hi = np.concatenate([edge_hi, hi]).astype(np.int32)
    return values, table, lo, hi


@pytest.mark.parametrize("rho,Q,distinct,block_q", [
    (1, 2, 1, 8), (2, 5, 2, 8), (64, 100, 3, 32), (257, 300, 1000, 128), (1000, 50, 2, 16),
])
def test_rmq_plain_matches_pallas(rho, Q, distinct, block_q):
    values, table, lo, hi = rmq_case(rho, Q, rho + Q, distinct)
    got = trmq.rmq_plain(_t(values), _t(table), _t(lo), _t(hi))
    args = tuple(jnp.asarray(a) for a in (values, table, lo, hi))
    _same(ref.rmq_ref(*args), got)
    _same(rmq_pallas(*args, block_q=block_q, interpret=True), got)
    # leftmost argmin of the inclusive range by a host scan (span 1 when hi < lo)
    want = [a + int(np.argmin(values[a:max(a, b) + 1])) for a, b in zip(lo, hi)]
    np.testing.assert_array_equal(got.numpy(), want)
    before = trmq.rmq.launches
    _same(np.asarray(got), trmq.rmq(_t(values), _t(table), _t(lo), _t(hi)))
    assert trmq.rmq.launches == before


# ---------------------------------------------------------------------------
# Kernel-routed Sada-I-D (lockstep machine + batched RMQ)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ilcp_case():
    from repro.core.ilcp import build_ilcp
    from repro.core.suffix import build_suffix_data, sa_range_for_pattern
    from repro.data.collections import SyntheticSpec, generate, random_substring_patterns
    from repro_torch import convert
    from repro_torch.core.ilcp import ILCPIndex

    coll = generate(SyntheticSpec("version", n_base=2, n_variants=6, base_len=80,
                                  mutation_rate=0.02, seed=13))
    data = build_suffix_data(coll)
    index = build_ilcp(data)
    ranges = [sa_range_for_pattern(data, p) for p in random_substring_patterns(coll, 300, 5, 32)]
    ranges += [(0, 0), (5, 5), (7, 3), (0, coll.n)]  # empty, inverted, everything
    lo = np.asarray([r[0] for r in ranges], np.int32)
    hi = np.asarray([r[1] for r in ranges], np.int32)
    tindex = convert.from_numpy(ILCPIndex, _fields(index), device="cpu")
    return coll, data, index, tindex, lo, hi


@pytest.mark.parametrize("max_df", [1, 2, 8, 64])
def test_ilcp_list_docs_da_batch_matches_reference(ilcp_case, max_df):
    from repro.core.ilcp import ilcp_list_docs_da_batch as jbatch
    from repro_torch.core.ilcp import ilcp_list_docs_da_batch, ilcp_list_docs_da_planned

    coll, data, index, tindex, lo, hi = ilcp_case
    da = _t(np.asarray(data.da))
    docs, cnt = ilcp_list_docs_da_batch(tindex, da, _t(lo), _t(hi), max_df)
    jd, jc = jbatch(index, jnp.asarray(data.da), jnp.asarray(lo), jnp.asarray(hi), max_df,
                    use_rmq_kernel=True)
    _same(jc, cnt)
    _same(jd, docs)  # discovery order, before any sort
    # the fused listing route gives the same integers
    fd, fc = ilcp_list_docs_da_planned(tindex, da, _t(lo), _t(hi), max_df)
    assert torch.equal(fd, docs) and torch.equal(fc, cnt)


def test_ilcp_rmq_hook_routes_every_iteration(ilcp_case):
    """``ilcp_list_plain`` resolves every lockstep iteration's pops with
    one call of its ``rmq_fn`` over the whole batch, and the default hook
    gives the same integers as the injected plain RMQ."""
    from repro_torch.kernels.ilcp_list import ilcp_list_plain, runs_of

    coll, data, index, tindex, lo, hi = ilcp_case
    arrays = (tindex.vilcp, tindex.rmq.table, tindex.run_starts, _t(np.asarray(data.da)))
    lr, hr = runs_of(tindex.run_starts, _t(lo)), runs_of(tindex.run_starts, _t(hi) - 1)
    calls = []

    def rmq_fn(a, b):
        calls.append(a.shape[0])
        return trmq.rmq_plain(tindex.vilcp, tindex.rmq.table, a, b)

    hooked = ilcp_list_plain(*arrays, _t(lo), _t(hi), lr, hr, d=coll.d, max_df=8, rmq_fn=rmq_fn)
    default = ilcp_list_plain(*arrays, _t(lo), _t(hi), lr, hr, d=coll.d, max_df=8)
    assert all(torch.equal(x, y) for x, y in zip(hooked, default))
    assert calls and set(calls) == {len(lo)}


# ---------------------------------------------------------------------------
# Empty batches: closed forms, no launch
# ---------------------------------------------------------------------------


def test_empty_batches(ilcp_case):
    from repro_torch.core.ilcp import ilcp_list_docs_da_batch

    coll, data, index, tindex, lo, hi = ilcp_case
    e = torch.zeros(0, dtype=torch.int32)
    words, prefix, _ = rank_case(3, 1, 0)
    assert trank.rank(_t(words.view(np.int32)), _t(prefix), e).shape == (0,)
    assert trmq.rmq(tindex.vilcp, tindex.rmq.table, e, e).shape == (0,)
    assert twm.wm_rank_batch(tindex.wm, e, e).shape == (0,)
    d, c = ilcp_list_docs_da_batch(tindex, _t(np.asarray(data.da)), e, e, 8)
    assert d.shape == (0, 8) and c.shape == (0,) and d.dtype == torch.int32
    d, c = ilcp_list_docs_da_batch(tindex, _t(np.asarray(data.da)), _t(lo), _t(hi), 0)
    assert d.shape == (len(lo), 0) and c.tolist() == [0] * len(lo)
