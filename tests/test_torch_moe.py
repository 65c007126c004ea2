"""The port's MoE FFN (``_moe_ffn``) against the reference's, on the CPU.

The same numpy-seeded activations and weights go through
``repro.models.transformer._moe_ffn`` (jitted once per configuration and
capacity) and ``repro_torch.models.transformer._moe_ffn``, for the reduced
``llama4-scout-17b-a16e`` (E = 4) and ``llama4-maverick-400b-a17b`` (E = 8)
configurations.  The routing is compared first and exactly: the expert of
each token and whether it reaches its expert (``keep``, in token order).
The reference's routing is read off its own lines (``transformer.py:
307-333``: scores in the activation dtype, f32 softmax, first argmax,
stable argsort, ``searchsorted``, slot < capacity) on the same input.  A
route that differs is reported with its top-2 gate margin.  Then the
output and the auxiliary loss.

Cases: the default capacity with a few drops; no drops (capacity T);
forced drops (a router whose first column dominates); the ``S == 1``
branch (decode: every expert, nothing dropped, aux 0); a
``capacity_factor`` override; fewer tokens than experts; bf16.

Tolerances: f32 1e-5 (summation order), bf16 2.5e-2 (the frameworks round
the products' outputs at different places), as ``tests/test_torch_lm.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama4_maverick_400b_a17b as jax_maverick
from repro.configs import llama4_scout_17b_a16e as jax_scout
from repro.models import transformer as jtf
from repro_torch.configs import llama4_maverick_400b_a17b, llama4_scout_17b_a16e
from repro_torch.models import transformer as ttf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = {"llama4-scout-17b-a16e": (jax_scout, llama4_scout_17b_a16e),
         "llama4-maverick-400b-a17b": (jax_maverick, llama4_maverick_400b_a17b)}
F32_TOL = 1e-5
BF16_TOL = 2.5e-2
#: weight scales: the router's wide enough that the gates spread
ROUTER_STD, EXPERT_STD = 0.2, 0.05

#: case -> (batch, seq, capacity_factor, bf16, forced)
CASES = {
    "default": (2, 16, None, False, False),
    "no_drops": (2, 16, "E", False, False),
    "forced_drops": (2, 16, None, False, True),
    "decode": (3, 1, None, False, False),
    "capacity_override": (2, 16, 0.5, False, False),
    "fewer_tokens_than_experts": (1, 3, None, False, False),
    "bf16": (2, 16, None, True, False),
}


def configs(arch, bf16=False):
    jmod, tmod = ARCHS[arch]
    jcfg, tcfg = jmod.reduced_config(), tmod.reduced_config()
    if bf16:
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16, act_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    return jcfg, tcfg


def jax_route(cfg, router, x, capacity_factor=None):
    """The reference's routing of x [B, S, D] (its ``_moe_ffn`` lines
    307-333): (top [T], kept [T] in token order, gate [T, E])."""
    B, S, D = x.shape
    E, T = cfg.moe.n_experts, B * S
    cf = cfg.moe.capacity_factor if capacity_factor is None else capacity_factor
    cap = max(1, min(T, int(T / E * cf)))
    scores = jnp.einsum("td,de->te", x.reshape(T, D), router).astype(jnp.float32)
    gate = jax.nn.softmax(scores, axis=-1)
    top = jnp.argmax(gate, axis=-1).astype(jnp.int32)
    if S == 1:
        return top, jnp.ones(T, bool), gate
    perm = jnp.argsort(top)
    top_sorted = top[perm]
    start = jnp.searchsorted(top_sorted, jnp.arange(E, dtype=jnp.int32))
    slot = jnp.arange(T, dtype=jnp.int32) - start[top_sorted]
    return top, jnp.zeros(T, bool).at[perm].set(slot < cap), gate


def port_route(route):
    """(top, kept, gate) of a port ``Route`` as numpy arrays."""
    return (route.top.numpy(), route.kept().numpy(), route.gate.detach().float().numpy())


def top2_margin(gate) -> np.ndarray:
    """Per token, the gap between its two largest gates."""
    g = np.sort(np.asarray(gate, np.float64), axis=-1)
    return g[:, -1] - g[:, -2]


def assert_same_routes(got, want, what=""):
    """Per layer, the expert and ``keep`` of every token equal; on a
    difference, the tokens and their top-2 gate margins in the message."""
    assert len(got) == len(want), (what, "routed layers", len(got), len(want))
    for layer, ((gt, gk, gg), (wt, wk, wg)) in enumerate(zip(got, want)):
        wt, wk = np.asarray(wt), np.asarray(wk)
        bad = np.flatnonzero((gt != wt) | (gk != wk))
        assert bad.size == 0, (
            f"{what} layer {layer}: routes differ at tokens {bad.tolist()}, expert "
            f"{gt[bad].tolist()} vs {wt[bad].tolist()}, kept {gk[bad].tolist()} vs "
            f"{wk[bad].tolist()}; top-2 gate margins {top2_margin(wg)[bad].tolist()}")


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _weights(tcfg, rng, forced):
    D, E, F = tcfg.d_model, tcfg.moe.n_experts, tcfg.moe.d_ff_expert or tcfg.d_ff
    w = {"router": rng.normal(0, ROUTER_STD, (D, E))}
    for name, shape in (("we_gate", (E, D, F)), ("we_up", (E, D, F)), ("we_down", (E, F, D)),
                        ("ws_gate", (D, tcfg.d_ff)), ("ws_up", (D, tcfg.d_ff)),
                        ("ws_down", (tcfg.d_ff, D))):
        w[name] = rng.normal(0, EXPERT_STD, shape)
    if forced:  # expert 0 takes nearly every token (the inputs' mean is positive)
        w["router"][:, 0] += 0.5
    return {k: v.astype(np.float32) for k, v in w.items()}


_JITTED = {}


def jax_moe(jcfg, capacity_factor):
    """The reference's ``_moe_ffn`` and routing, jitted once per config and
    capacity factor."""
    key = (jcfg, capacity_factor)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda p, x: (jtf._moe_ffn(jcfg, p, x, capacity_factor),
                                             jax_route(jcfg, p["router"], x, capacity_factor)))
    return _JITTED[key]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_ffn_matches_reference(arch, case, monkeypatch):
    B, S, cf, bf16, forced = CASES[case]
    jcfg, tcfg = configs(arch, bf16)
    E = tcfg.moe.n_experts
    if cf == "E":
        cf = float(E)
    rng = np.random.default_rng(sorted(CASES).index(case))
    w = _weights(tcfg, rng, forced)
    x = rng.normal(0.5 if forced else 0.0, 1.0, (B, S, tcfg.d_model)).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    (want, want_aux), want_route = jax_moe(jcfg, cf)(
        {k: jnp.asarray(v, jdt) for k, v in w.items()}, jnp.asarray(x, jdt))
    # the port's weights and input: the reference's values, bit for bit
    tdt = tcfg.act_dtype
    tw = {k: torch.from_numpy(v).to(tdt) for k, v in w.items()}
    routes = []
    route = ttf._route

    def recording_route(*a):
        r = route(*a)
        routes.append(port_route(r))
        return r

    monkeypatch.setattr(ttf, "_route", recording_route)
    got, aux = ttf._moe_ffn(tcfg, tw, torch.from_numpy(x).to(tdt), cf)
    assert_same_routes(routes, [want_route], f"{arch} {case}")

    T = B * S
    kept = routes[0][1]
    cap = ttf.moe_capacity(tcfg, T, cf)
    assert cap == max(1, min(T, int(T / E * (cf or 1.25))))
    if case == "no_drops" or S == 1:
        assert kept.all()
    if case == "forced_drops":
        n0 = int((routes[0][0] == 0).sum())
        assert n0 > T // 2 and int((~kept).sum()) == n0 - cap
    if case == "default":
        assert (~kept).any()  # the default capacity drops a few here
    assert got.shape == (B, S, tcfg.d_model) and got.dtype == tdt
    _close(got, want, BF16_TOL if bf16 else F32_TOL)
    if S == 1:
        assert aux == 0.0 and float(want_aux) == 0.0
    else:
        assert aux.dtype == torch.float32 and aux.shape == ()
        # in bf16 the gates come from bf16 scores, which may round apart
        tol = BF16_TOL if bf16 else F32_TOL
        assert abs(float(aux) - float(want_aux)) <= tol * abs(float(want_aux))


def test_dropped_tokens_keep_only_the_shared_expert():
    """A dropped token's routed output is 0: with the shared expert's down
    projection zeroed, its output row is 0 and every kept row is not."""
    _, tcfg = configs("llama4-scout-17b-a16e")
    rng = np.random.default_rng(7)
    w = {k: torch.from_numpy(v) for k, v in _weights(tcfg, rng, True).items()}
    w["ws_down"].zero_()
    x = torch.from_numpy(rng.normal(0.5, 1.0, (2, 16, tcfg.d_model)).astype(np.float32))
    y, _ = ttf._moe_ffn(tcfg, w, x)
    r = ttf._route(tcfg, w["router"], x.reshape(32, -1), ttf.moe_capacity(tcfg, 32))
    kept = r.kept()
    assert (~kept).any() and kept.any()
    norms = y.reshape(32, -1).abs().amax(dim=-1)
    assert bool((norms[~kept] == 0).all()) and bool((norms[kept] > 0).all())
