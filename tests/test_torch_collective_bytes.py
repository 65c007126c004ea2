"""The dry run's collective term (``dist.roofline``'s byte formulas,
``launch.dryrun.collective_term``) and the ``molecule`` cell's per-rank
program, on the CPU.

One world of 4 gloo ranks (``spawn_ranks``; inputs through an ``.npz``
file) runs each per-rank program once with ``mesh.traffic`` reset before
it, and every formula must equal the bytes counted, exactly:

* ``tp_prefill_bytes`` and ``tp_decode_bytes``: a prefill of 4 x 32 tokens
  (a data shard of it) and 2 decode steps of the reduced llama3.2-3b
  (dense) and Scout (MoE), on (2, 2) and (1, 4), FSDP off and forced on
  (every leaf but the router, as the registry turns it on; on (1, 4) there
  is no data axis, and the forced specs are the plain ones);
* ``recsys_bytes``: the registry's ``serve_p99``, ``retrieval_cand`` and
  ``train_batch`` cells of each recsys model, its reduced config widened to
  one table of 70,000 ids so that the table is row-sharded over ``model``;
* ``gnn_bytes``: NequIP's partitioned step (``build_partition``) on 64
  nodes, and the registry's ``molecule`` cell, whose specs split nodes and
  edges over all 4 ranks, on 256 nodes.

The ``molecule`` cell's step on the ranks gathers the graph and runs the
dense step: its loss and gradient within 1e-5 of the largest magnitude of
the one-rank step's on the same full graph (its parameters from the
reference's ``init_params``) and of the reference's ``jax.value_and_grad``
of ``forward_train``; the step's first moments (a tenth of the clipped
gradient) within 1e-5 of the one-rank step's.  The updated parameters are
not compared: a first AdamW step moves a parameter by about lr * g / |g|,
which flips where g is near 0, and the same gradient computed twice on
one rank differs in its last bits (measured: up to 1.5e-7 of a leaf's
largest first moment).

The dry run: every one of the 40 cells has a ``collective`` dict on both
production meshes; ``full_graph_sm`` moves 0 bytes; a served LM cell's
bytes are ``tp_prefill_bytes`` or ``tp_decode_bytes`` of a rank's rows.
"""

import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import nequip as jnq_cfgs
from repro.models import nequip as jnq
from repro_torch.configs import registry as treg
from repro_torch.configs import nequip as tnq_cfgs
from repro_torch.data.pipelines import random_graph
from repro_torch.dist.roofline import (
    H100_NVLINK_BPS,
    gnn_bytes,
    recsys_bytes,
    tp_decode_bytes,
    tp_prefill_bytes,
)
from repro_torch.dist.sharding import P, axes_for_mesh, lm_param_specs, local_shard, zero_spec_for
from repro_torch.dist.step import partitioned_train_step, shard_tree, unshard_tree
from repro_torch.dist.tp import Layout
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_rank_mesh, make_production_mesh, spawn_ranks
from repro_torch.models import nequip as tnq
from repro_torch.models import transformer as tf
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.tree import flatten, unflatten


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


AXES = ("data", "model")
TOL = 1e-5
B, S = 4, 32
#: (arch, mesh shape, FSDP forced)
LM = [(arch, mesh, fsdp) for arch in ("llama3.2-3b", "llama4-scout-17b-a16e")
      for mesh in ((2, 2), (1, 4)) for fsdp in (False, True)]
LM_IDS = [f"{a}-{m[0]}x{m[1]}{'-fsdp' if f else ''}" for a, m, f in LM]
BIG = 70_000
#: each recsys model's reduced config with one table of 2^16 rows or more
WIDEN = {"fm": dict(vocab_sizes=(BIG, 60, 70, 80, 90)), "sasrec": dict(n_items=BIG),
         "autoint": dict(vocab_sizes=(BIG, 60, 70, 80, 90)),
         "dlrm-mlperf": dict(vocab_sizes=(BIG, 200, 300, 400))}
RECSYS = [(arch, shape) for arch in WIDEN
          for shape in ("serve_p99", "retrieval_cand", "train_batch")]
RECSYS_IDS = [f"{a}-{s}" for a, s in RECSYS]
#: the partitioned step's graph (reduced NequIP) and the molecule cell's
PART_GRAPH = dict(n_nodes=64, n_edges=256, n_graphs=4, seed=3)
MOL_GRAPH = dict(n_nodes=256, n_edges=512, seed=4)


def _lm_config(arch):
    return treg.get_arch_module(arch).reduced_config()


def _lm_specs(cfg, mesh, fsdp):
    axes = axes_for_mesh(mesh)
    pabs = tf.init_params(cfg, None, device="meta")
    ps = lm_param_specs(cfg, axes, mesh, pabs)
    if not fsdp:
        return ps
    dpn = mesh.shape["data"]
    leaves, paths = flatten(pabs)
    return unflatten(ps, [s if p[-1] == "router" else zero_spec_for(s, tuple(a.shape), axes, dpn)
                          for s, a, p in zip(flatten(ps)[0], leaves, paths)])


def _recsys_config(arch):
    return dataclasses.replace(treg.get_arch_module(arch).reduced_config(), **WIDEN[arch])


def _mol_config():
    return tnq_cfgs.config(d_feat_in=treg.GNN_SHAPES["molecule"]["d_feat"])


def _recsys_inputs(rng, arch, cfg, n_rows, n_cand):
    """Uniform ids over every table's rows: the serve and train batches and
    the retrieval's arguments after the parameters."""
    if arch == "sasrec":
        seq = lambda b: rng.integers(0, cfg.n_items, (b, cfg.seq_len)).astype(np.int32)  # noqa: E731
        train = {"item_seq": seq(n_rows), "label": (rng.random(n_rows) < 0.3).astype(np.float32),
                 "neg_items": seq(n_rows), "pos_items": seq(n_rows)}
        serve = {"item_seq": seq(n_rows),
                 "target": rng.integers(1, cfg.n_items, n_rows).astype(np.int32)}
        retr = [seq(1)]
    else:
        ids = lambda b: np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes],  # noqa: E731
                                 1).astype(np.int32)
        train = {"label": (rng.random(n_rows) < 0.3).astype(np.float32), "sparse": ids(n_rows)}
        serve = {"sparse": ids(n_rows)}
        retr = [ids(1)[0]]
        if arch == "dlrm-mlperf":
            dense = lambda b: rng.standard_normal((b, cfg.n_dense)).astype(np.float32)  # noqa: E731
            train["dense"], serve["dense"] = dense(n_rows), dense(n_rows)
            retr = [dense(1)[0]] + retr
    first = cfg.n_items if arch == "sasrec" else cfg.vocab_sizes[0]
    retr.append(rng.integers(0, first, n_cand).astype(np.int32))
    return {"serve_p99": serve, "train_batch": train, "retrieval_cand": retr}


def _inputs():
    """Every input of the ranks, numpy-seeded; the molecule cell's
    parameters are the reference's ``init_params`` (flattened in the
    port's order, which is ``jax.tree.leaves``')."""
    rng = np.random.default_rng(17)
    out = {"tokens": rng.integers(0, 512, (B, S + 2)).astype(np.int32)}
    for arch in WIDEN:
        for shape, x in _recsys_inputs(rng, arch, _recsys_config(arch), 8, 64).items():
            leaves = list(x) if isinstance(x, list) else [x[k] for k in sorted(x)]
            for i, leaf in enumerate(leaves):
                out[f"{arch}/{shape}/{i}"] = leaf
    g = random_graph(PART_GRAPH["n_nodes"], PART_GRAPH["n_edges"],
                     tnq_cfgs.reduced_config().d_feat_in, n_graphs=PART_GRAPH["n_graphs"],
                     seed=PART_GRAPH["seed"])
    part = tnq.build_partition(g["node_feat"], g["edge_index"], g["edge_vec"], g["graph_id"], 4)
    out.update({f"part/{k}": v for k, v in part.items()}, **{"part/energy": g["energy"]})
    info = treg.GNN_SHAPES["molecule"]
    mol = random_graph(MOL_GRAPH["n_nodes"], MOL_GRAPH["n_edges"], info["d_feat"],
                       n_graphs=info["n_graphs"], seed=MOL_GRAPH["seed"])
    out.update({f"mol/{k}": v for k, v in mol.items()})
    jcfg = jnq_cfgs.config(d_feat_in=info["d_feat"])
    jp = jax.jit(lambda key: jnq.init_params(jcfg, key))(jax.random.PRNGKey(2))
    for i, leaf in enumerate(jax.tree.leaves(jp)):
        out[f"mol_p/{i}"] = np.asarray(leaf)
    return out, jp


def _tree(inp, prefix, like):
    n = len(flatten(like)[0])
    return unflatten(like, [torch.from_numpy(inp[f"{prefix}{i}"]) for i in range(n)])


def _lm_rank(rank_mesh, inp):
    out = []
    tokens = torch.from_numpy(inp["tokens"])
    for arch, shape, fsdp in LM:
        rm = rank_mesh(shape)
        cfg = _lm_config(arch)
        ps = _lm_specs(cfg, rm.mesh, fsdp)
        params = shard_tree(tf.init_params(cfg, torch.Generator().manual_seed(1), device="cpu"),
                            ps, rm)
        tok = local_shard(tokens, P("data", None), rm.shape, dict(zip(AXES, rm.coords)))
        lay = Layout(cfg, rm, ps, params)
        with torch.no_grad():
            rm.reset_traffic()
            _, cache = tf.forward_prefill(cfg, params, tok[:, :S], max_seq=S + 2, layout=lay)
            got = {"prefill": rm.traffic["bytes"], "decode": []}
            for k in range(2):
                rm.reset_traffic()
                tf.forward_decode(cfg, params, tok[:, S + k], cache, S + k, layout=lay)
                got["decode"].append(rm.traffic["bytes"])
        got["prefill_formula"] = tp_prefill_bytes(cfg, rm, ps, (tok.shape[0], S))
        got["decode_formula"] = tp_decode_bytes(cfg, rm, ps, tok.shape[0])
        out.append(got)
    return out


def _recsys_rank(mesh, inp):
    mods = {arch: treg.get_arch_module(arch) for arch in WIDEN}
    saved = {arch: mod.reduced_config for arch, mod in mods.items()}
    coords = dict(zip(AXES, mesh.coords))
    out = []
    try:  # the registry's reduced configs widened while the cells are built
        for arch, mod in mods.items():
            mod.reduced_config = lambda cfg=_recsys_config(arch): cfg
        for arch, shape in RECSYS:
            cfg = _recsys_config(arch)
            cell = treg.build_cell(arch, shape, reduced=True, mesh=mesh)
            full = treg.RECSYS[arch][0](cfg, torch.Generator().manual_seed(3), device="cpu")
            params = shard_tree(full, cell.in_specs[0], mesh)
            n_args = len(cell.abstract_args) - 1
            if cell.kind == "retrieval":
                args = [local_shard(torch.from_numpy(inp[f"{arch}/{shape}/{i}"]), s, mesh.shape,
                                    coords) for i, s in enumerate(cell.in_specs[1:])]
                rows = args[-1].shape[0]
            else:
                like = cell.abstract_args[-1]
                args = [shard_tree(_tree(inp, f"{arch}/{shape}/", like), cell.in_specs[-1], mesh)]
                rows = flatten(args[0])[0][0].shape[0]
                if cell.kind == "train":
                    args.insert(0, shard_tree(adamw_init(full), cell.in_specs[1], mesh))
            assert len(args) == n_args
            mesh.reset_traffic()
            if cell.kind == "train":
                cell.step_fn(params, *args)
            else:
                with torch.no_grad():
                    cell.step_fn(params, *args)
            out.append({"bytes": mesh.traffic["bytes"], "formula": recsys_bytes(
                cell.kind, cfg, mesh, cell.abstract_args[0], cell.in_specs[0], rows,
                cell.in_specs[1]["m"] if cell.kind == "train" else None)})
    finally:
        for arch, mod in mods.items():
            mod.reduced_config = saved[arch]
    return out


def _gnn_rank(mesh, inp):
    coords = dict(zip(AXES, mesh.coords))
    # the partitioned step of the reduced NequIP
    cfg = tnq_cfgs.reduced_config()
    keys = ("node_feat", "edge_src", "edge_dst", "edge_vec", "export_idx", "graph_id")
    whole = {k: torch.from_numpy(inp[f"part/{k}"]) for k in keys + ("energy",)}
    spec = P(AXES)
    batch = {k: local_shard(whole[k], spec, mesh.shape, coords) for k in keys}
    batch["energy"] = whole["energy"]
    params = tnq.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    loss_fn = tnq.partitioned_train_step_fn(cfg, mesh, PART_GRAPH["n_graphs"])
    mesh.reset_traffic()
    partitioned_train_step(loss_fn, mesh, AdamWConfig())(params, adamw_init(params), batch)
    out = {"partitioned": {"bytes": mesh.traffic["bytes"], "formula": gnn_bytes(
        mesh, params, whole, {k: P() if k == "energy" else spec for k in whole})}}
    # the registry's molecule cell, on a graph smaller than its shape's
    cell = treg.build_cell("nequip", "molecule", mesh=mesh)
    bspecs = cell.in_specs[2]
    graph = {k: torch.from_numpy(inp[f"mol/{k}"]) for k in cell.abstract_args[2]}
    params = _tree(inp, "mol_p/", cell.abstract_args[0])
    mesh.reset_traffic()
    _, newo, loss = cell.step_fn(params, adamw_init(params), shard_tree(graph, bspecs, mesh))
    sent = mesh.traffic["bytes"]
    gathered = unshard_tree(shard_tree(graph, bspecs, mesh), bspecs, mesh)
    G = treg.GNN_SHAPES["molecule"]["n_graphs"]
    gloss, grads = value_and_grad(lambda p, b: tnq.forward_train(_mol_config(), p, b, G),
                                  params, gathered)
    out["molecule"] = {
        "bytes": sent, "formula": gnn_bytes(mesh, params, graph, bspecs),
        "specs": [tuple(bspecs[k]) for k in sorted(bspecs)],
        "gathered": all(torch.equal(gathered[k], graph[k]) for k in graph),
        "loss": float(loss), "grad_loss": float(gloss), "grads": flatten(grads)[0],
        "m": flatten(newo["m"])[0]}
    return out


def _rank(mesh, path):
    inp = dict(np.load(path))
    meshes = {mesh.mesh.sizes: mesh}

    def rank_mesh(shape):
        if shape not in meshes:
            meshes[shape] = init_rank_mesh(shape, AXES, "gloo", "cpu")
        return meshes[shape]

    return {"lm": _lm_rank(rank_mesh, inp), "recsys": _recsys_rank(mesh, inp),
            "gnn": _gnn_rank(mesh, inp)}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("bytes")
    inp, jp = _inputs()
    np.savez(d / "in.npz", **inp)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the ranks beside the rest
        ranks = pool.submit(spawn_ranks, _rank, (2, 2), "gloo", "cpu",
                            args=(str(d / "in.npz"),), axes=AXES, timeout_s=300)
        one, ref = _one_rank_and_reference(inp, jp)
        return ranks.result(), one, ref


def _one_rank_and_reference(inp, jp):
    """The molecule graph's dense step on one rank, and the reference's
    loss and gradient on it."""
    cell = treg.build_cell("nequip", "molecule")
    params = _tree(inp, "mol_p/", cell.abstract_args[0])
    graph = {k: torch.from_numpy(v) for k, v in inp.items() if k.startswith("mol/")}
    graph = {k.removeprefix("mol/"): v for k, v in graph.items()}
    _, newo, loss = cell.step_fn(params, adamw_init(params), graph)
    G = treg.GNN_SHAPES["molecule"]["n_graphs"]
    _, grads = value_and_grad(lambda p, b: tnq.forward_train(_mol_config(), p, b, G), params,
                              graph)
    jcfg = jnq_cfgs.config(d_feat_in=treg.GNN_SHAPES["molecule"]["d_feat"])
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jnq.forward_train(jcfg, p, b, G)))(
        jp, {k: np.asarray(v) for k, v in graph.items()})
    one = {"loss": float(loss), "grads": flatten(grads)[0], "m": flatten(newo["m"])[0]}
    ref = {"loss": float(jl), "grads": [np.asarray(x) for x in jax.tree.leaves(jg)]}
    return one, ref


@pytest.mark.parametrize("i", range(len(LM)), ids=LM_IDS)
def test_lm_prefill_and_decode_bytes(runs, i):
    """``tp_prefill_bytes`` and ``tp_decode_bytes`` equal the bytes every
    rank's collectives counted in a prefill and in each decode step."""
    for r in runs[0]:
        got = r["lm"][i]
        assert got["prefill"] == got["prefill_formula"] > 0
        assert got["decode"] == [got["decode_formula"]] * 2 and got["decode_formula"] > 0


def test_fsdp_adds_the_gathers(runs):
    """Forced FSDP on (2, 2) adds the weights' gathers to a prefill's and a
    decode step's bytes; on (1, 4) it shards nothing."""
    r = runs[0][0]["lm"]
    for arch in ("llama3.2-3b", "llama4-scout-17b-a16e"):
        plain, fsdp = (LM.index((arch, (2, 2), f)) for f in (False, True))
        assert r[fsdp]["prefill"] > r[plain]["prefill"]
        assert r[fsdp]["decode"][0] > r[plain]["decode"][0]
        plain, fsdp = (LM.index((arch, (1, 4), f)) for f in (False, True))
        assert r[fsdp] == r[plain]


@pytest.mark.parametrize("i", range(len(RECSYS)), ids=RECSYS_IDS)
def test_recsys_bytes(runs, i):
    """``recsys_bytes`` equals the bytes of one call of the registry's
    cell on every rank: the row-sharded lookups' sums or, in a retrieval,
    the ids' gathers and the rows' reduce-scatters; in training, also the
    loss's mean and the ZeRO-1 step."""
    for r in runs[0]:
        assert r["recsys"][i]["bytes"] == r["recsys"][i]["formula"] > 0


@pytest.mark.parametrize("case", ["partitioned", "molecule"])
def test_gnn_bytes(runs, case):
    """``gnn_bytes`` equals the bytes of one step: the partitioned one's
    halo gathers, their reduce-scatters, the energies' sum and the
    gradient's sums; the molecule cell's gathers of its graph."""
    for r in runs[0]:
        assert r["gnn"][case]["bytes"] == r["gnn"][case]["formula"] > 0


def test_molecule_cell_gathers_its_graph(runs):
    """On a rank mesh the molecule cell's specs split nodes and edges over
    every rank, and its step gathers them back into the whole graph."""
    all_axes = tuple(AXES)
    for r in runs[0]:
        mol = r["gnn"]["molecule"]
        assert mol["gathered"]
        # edge_index, edge_vec, energy, graph_id, node_feat
        assert mol["specs"] == [(None, all_axes), (all_axes, None), (), (all_axes,),
                                (all_axes, None)]


def test_molecule_step_matches_one_rank_and_the_reference(runs):
    """Every rank's loss and gradient within 1e-5 of the one-rank step's and
    of the reference's; the step's first moments (a tenth of the clipped
    gradient) within 1e-5 of the one-rank step's."""
    port, one, ref = runs
    for r in port:
        mol = r["gnn"]["molecule"]
        assert mol["loss"] == mol["grad_loss"]
        for want in (one["loss"], ref["loss"]):
            assert abs(mol["loss"] - want) <= TOL * abs(want)
        for g, w1, wr in zip(mol["grads"], one["grads"], ref["grads"]):
            _close(g, w1)
            _close(g, wr)
        for g, w in zip(mol["m"], one["m"]):
            _close(g, w)


def test_one_rank_molecule_step_is_the_dense_step():
    """On one rank (the host mesh) the molecule cell keeps the one-card
    step; ``full_graph_sm`` keeps it on every mesh (replicated specs)."""
    cell = treg.build_cell("nequip", "molecule")
    assert cell.step_fn.__qualname__.startswith("_train_step")
    cell = treg.build_cell("nequip", "full_graph_sm", mesh=make_production_mesh())
    assert cell.step_fn.__qualname__.startswith("_train_step")


@pytest.fixture(scope="module")
def production_cells():
    """Every cell on both production meshes (``meta`` inputs)."""
    out = {}
    for label, multi in dryrun.PRODUCTION_MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        for arch, shape in treg.all_cells():
            out[arch, shape, label] = (treg.build_cell(arch, shape, mesh=mesh), mesh)
    return out


def test_every_cell_has_a_collective_term(production_cells):
    """All 40 cells on both production meshes: a dict of the mesh's chips,
    the bytes a rank sends and the roofline with them; 0 bytes for the
    replicated ``full_graph_sm`` only."""
    assert len(production_cells) == 80
    for (arch, shape, label), (cell, mesh) in production_cells.items():
        term = dryrun.collective_term(cell, mesh, reduced=False)
        assert term["chips"] == mesh.size
        assert term["roofline"]["collective_s"] == term["bytes_a_rank"] / H100_NVLINK_BPS
        assert (term["bytes_a_rank"] == 0) == (shape == "full_graph_sm"), (arch, shape, label)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_served_lm_cell_term(production_cells, shape):
    """A served LM cell's term is the formula on a rank's rows: prefill's
    32 prompts over the data axes, decode's 128, and ``long_500k``'s one
    sequence, which the batch does not split."""
    cfg = treg.get_arch_module("llama3.2-3b").config()
    info = treg.LM_SHAPES[shape]
    for label in dryrun.PRODUCTION_MESHES:
        cell, mesh = production_cells["llama3.2-3b", shape, label]
        dp = mesh.size // mesh.shape["model"]
        rows = info["batch"] // dp if info["batch"] % dp == 0 else info["batch"]
        want = (tp_prefill_bytes(cfg, mesh, cell.in_specs[0], (rows, info["seq"]))
                if info["kind"] == "prefill" else tp_decode_bytes(cfg, mesh, cell.in_specs[0],
                                                                  rows))
        assert dryrun.collective_term(cell, mesh, reduced=False)["bytes_a_rank"] == want > 0


def test_dry_run_reports_the_term():
    """``run_cell`` puts the term of each production mesh in its result."""
    r = dryrun.run_cell("nequip", "full_graph_sm", reduced=True, verbose=False)
    assert set(r["collective"]) == set(dryrun.PRODUCTION_MESHES)
    assert all(t["bytes_a_rank"] == 0 for t in r["collective"].values())
    r = dryrun.run_cell("fm", "serve_p99", reduced=True, verbose=False)
    for label, multi in dryrun.PRODUCTION_MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        cell = treg.build_cell("fm", "serve_p99", reduced=True, mesh=mesh)
        assert r["collective"][label] == dryrun.collective_term(cell, mesh, reduced=True)
