"""The port's kernel plain versions against the JAX Pallas kernels.

Each plain version (the CPU path of its wrapper, and the card's yardstick)
must give the integers of the reference's Pallas kernel in interpret mode
and of its ``ref`` oracle: exact equality, dtype included.  Shapes cover a
batch that is not a multiple of the block, length-0 rows, symbols outside
the alphabet (-1 and sigma), df > max_df truncation, padded rows whose
``hi_run`` is -1, and ``max_df = 1``.  ILCP rows compare in discovery order.
The CUDA kernels themselves run only on the card (``chip_smoke.py``); their
shared core is compiled for the host in ``test_torch_kernel_core.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops, ref
from repro.kernels.backward_search import backward_search_pallas
from repro.kernels.ilcp_list import ilcp_list_pallas
from repro.succinct.wavelet import wm_build as jax_wm_build
from repro_torch.kernels import backward_search as tbs
from repro_torch.kernels import ilcp_list as til


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


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# backward search
# ---------------------------------------------------------------------------


def _bws_case(n, sigma, Q, max_m, seed):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, sigma, n)
    wm = jax_wm_build(seq, sigma)
    counts = np.concatenate([[0], np.cumsum(np.bincount(seq, minlength=sigma))])
    base = jnp.asarray(counts[:sigma], jnp.int32) - wm.sym_starts
    pats = np.zeros((Q, max_m), np.int32)
    lens = rng.integers(0, max_m + 1, Q).astype(np.int32)
    for qi in range(Q):
        m = int(lens[qi])
        if m and rng.random() < 0.5:
            start = rng.integers(0, n - m + 1)
            pats[qi, :m] = seq[start : start + m]
        elif m:
            pats[qi, :m] = rng.integers(0, sigma, m)
        if m and rng.random() < 0.3:
            pats[qi, rng.integers(0, m)] = rng.choice([-1, sigma, -4, sigma + 2])
    lens[0] = 0  # always one length-0 row
    return wm, base, pats, lens


def _torch_index(wm, base):
    return (_t(np.asarray(wm.words).view(np.int32)), _t(wm.ones_prefix),
            _t(wm.zcount), _t(base))


@pytest.mark.parametrize("sigma", [2, 5, 37])
@pytest.mark.parametrize("Q,block_q", [(1, 256), (33, 8), (64, 16)])
def test_backward_search_plain_matches_pallas(sigma, Q, block_q):
    n, max_m = 500, 9
    wm, base, pats, lens = _bws_case(n, sigma, Q, max_m, seed=Q * 31 + sigma)
    rev = tbs.reverse_patterns(_t(pats), _t(lens))
    lo, hi = tbs.backward_search_plain(*_torch_index(wm, base), rev, _t(lens),
                                       n=n, sigma=sigma)
    jl, jh = backward_search_pallas(
        wm.words, wm.ones_prefix, wm.zcount, base, jnp.asarray(rev.numpy()),
        jnp.asarray(lens), n=n, sigma=sigma, block_q=block_q, interpret=True,
    )
    _same(jl, lo)
    _same(jh, hi)
    rl, rh = ref.backward_search_ref(wm.words, wm.ones_prefix, wm.zcount, base,
                                     jnp.asarray(rev.numpy()), jnp.asarray(lens),
                                     n=n, sigma=sigma)
    _same(rl, lo)
    _same(rh, hi)
    # the wrapper on CPU tensors takes natural-order rows and the plain path
    before = tbs.backward_search.launches
    wl, wh = tbs.backward_search(*_torch_index(wm, base), _t(pats), _t(lens),
                                 n=n, sigma=sigma)
    _same(jl, wl)
    _same(jh, wh)
    assert tbs.backward_search.launches == before  # no kernel launch on the CPU


def test_backward_search_reversal_matches_ops():
    wm, base, pats, lens = _bws_case(300, 6, 20, 7, seed=4)
    j = jnp.clip(jnp.asarray(lens)[:, None] - 1 - jnp.arange(7)[None, :], 0, 6)
    want = jnp.take_along_axis(jnp.asarray(pats), j, axis=1)
    _same(want, tbs.reverse_patterns(_t(pats), _t(lens)))


def test_backward_search_oob_and_degenerate():
    wm, base, pats, lens = _bws_case(300, 6, 32, 7, seed=2)
    pats[:, 3] = np.where(np.arange(32) % 2 == 0, 6 + 4, -2)
    lens[:] = 7
    idx = _torch_index(wm, base)
    lo, hi = tbs.backward_search(*idx, _t(pats), _t(lens), n=300, sigma=6)
    assert torch.equal(lo, hi)
    jl, jh = ops.backward_search(wm.words, wm.ones_prefix, wm.zcount, base,
                                 jnp.asarray(pats), jnp.asarray(lens), n=300, sigma=6,
                                 block_q=8, interpret=True)
    _same(jl, lo)
    _same(jh, hi)
    # B == 0 and max_m == 0
    e_lo, e_hi = tbs.backward_search(*idx, torch.zeros((0, 5), dtype=torch.int32),
                                     torch.zeros(0, dtype=torch.int32), n=300, sigma=6)
    assert e_lo.shape == e_hi.shape == (0,) and e_lo.dtype == torch.int32
    z_lo, z_hi = tbs.backward_search(*idx, torch.zeros((4, 0), dtype=torch.int32),
                                     torch.zeros(4, dtype=torch.int32), n=300, sigma=6)
    assert z_lo.tolist() == [0] * 4 and z_hi.tolist() == [300] * 4


# ---------------------------------------------------------------------------
# ILCP listing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ilcp_case():
    from repro.core.ilcp import build_ilcp
    from repro.core.suffix import build_suffix_data, sa_range_for_pattern
    from repro.data.collections import SyntheticSpec, generate, random_substring_patterns

    coll = generate(SyntheticSpec("version", n_base=2, n_variants=6, base_len=80,
                                  mutation_rate=0.02, seed=13))
    data = build_suffix_data(coll)
    index = build_ilcp(data)
    ranges = [sa_range_for_pattern(data, p) for p in random_substring_patterns(coll, 300, 5, 32)]
    ranges += [(0, 0), (5, 5), (7, 3), (0, coll.n)]  # empty, inverted, everything
    lo = np.asarray([r[0] for r in ranges], np.int32)
    hi = np.asarray([r[1] for r in ranges], np.int32)
    return coll, data, index, lo, hi


def _ilcp_torch(index, data):
    return (_t(index.vilcp), _t(index.rmq.table), _t(index.run_starts), _t(data.da))


@pytest.mark.parametrize("max_df,block_q", [(1, 128), (2, 128), (8, 4), (64, 128)])
def test_ilcp_list_plain_matches_pallas(ilcp_case, max_df, block_q):
    from repro.core.ilcp import ilcp_list_docs_da_batch

    coll, data, index, lo, hi = ilcp_case
    jlo, jhi = jnp.asarray(lo), jnp.asarray(hi)
    lo_run = ops.runs_of(index.run_starts, jlo)
    hi_run = ops.runs_of(index.run_starts, jhi - 1)
    arrays = _ilcp_torch(index, data)
    t_lo_run = til.runs_of(arrays[2], _t(lo))
    t_hi_run = til.runs_of(arrays[2], _t(hi) - 1)
    _same(lo_run, t_lo_run)
    _same(hi_run, t_hi_run)
    assert int(t_hi_run[-4]) == -1  # the (0, 0) row is a padded root

    docs, cnt = til.ilcp_list_plain(*arrays, _t(lo), _t(hi), t_lo_run, t_hi_run,
                                    d=coll.d, max_df=max_df)
    pd, pc = ilcp_list_pallas(index.vilcp, index.rmq.table, index.run_starts,
                              jnp.asarray(data.da), jlo, jhi, lo_run, hi_run,
                              d=coll.d, max_df=max_df, block_q=block_q, interpret=True)
    _same(pc, cnt)
    _same(pd, docs)  # discovery order, before any sort
    rd, rc = ref.ilcp_list_ref(index.vilcp, index.rmq.table, index.run_starts,
                               jnp.asarray(data.da), jlo, jhi, lo_run, hi_run,
                               d=coll.d, max_df=max_df)
    _same(rc, cnt)
    _same(rd, docs)
    vd, vc = ilcp_list_docs_da_batch(index, jnp.asarray(data.da), jlo, jhi, max_df)
    _same(vc, cnt)
    _same(np.asarray(vd)[:, :max_df], docs)
    # the wrapper on CPU tensors: the plain path, no launch counted
    before = til.ilcp_list.launches
    wd, wc = til.ilcp_list(*arrays, _t(lo), _t(hi), d=coll.d, max_df=max_df)
    _same(pd, wd)
    _same(pc, wc)
    assert til.ilcp_list.launches == before
    truth_df = np.asarray([len(set(np.asarray(data.da)[a:b].tolist())) if a < b else 0
                           for a, b in zip(lo, hi)])
    assert (truth_df > max_df).any() or max_df == 64  # truncation is exercised
    np.testing.assert_array_equal(cnt.numpy(), np.minimum(truth_df, max_df))


def test_ilcp_list_closed_forms(ilcp_case):
    coll, data, index, lo, hi = ilcp_case
    arrays = _ilcp_torch(index, data)
    e = torch.zeros(0, dtype=torch.int32)
    d0, c0 = til.ilcp_list(*arrays, e, e, d=coll.d, max_df=8)
    assert d0.shape == (0, 8) and c0.shape == (0,)
    d1, c1 = til.ilcp_list(*arrays, _t(lo), _t(hi), d=coll.d, max_df=0)
    assert d1.shape == (len(lo), 0) and c1.tolist() == [0] * len(lo)
    jd, jc = ops.ilcp_list(index.vilcp, index.rmq.table, index.run_starts,
                           jnp.asarray(data.da), jnp.asarray(lo), jnp.asarray(hi),
                           d=coll.d, max_df=0, interpret=True)
    _same(jd, d1)
    _same(jc, c1)


def test_ilcp_list_oob_ranges_stay_empty(ilcp_case):
    coll, data, index, _, _ = ilcp_case
    n = coll.n
    lo = np.asarray([0, n, n - 1, 17], np.int32)
    hi = np.asarray([0, n, n - 1, 2], np.int32)
    docs, cnt = til.ilcp_list(*_ilcp_torch(index, data), _t(lo), _t(hi), d=coll.d, max_df=8)
    assert cnt.tolist() == [0, 0, 0, 0]
    assert bool((docs == -1).all())
