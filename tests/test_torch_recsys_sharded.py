"""Row-sharded recsys tables run as per-rank programs
(``models.recsys.RowBlock``, ``row_blocks``, the registry's multi-rank
recsys cells) against the reference's ``jax.jit`` of its own cells on the
CPU.

Each model's reduced config with one table of 2^16 rows or more (a first
field, or SASRec's items, of 70,000 ids: the concatenated table pads to
70,656 rows), so that ``recsys_param_specs`` row-shards it over ``model``.
The reference runs once per module in subprocesses with 4 host devices on
Auto-axis meshes: each cell that its registry builds for that config (its
``reduced_config`` replaced in the subprocess) is jitted with
``NamedSharding``s of the cell's own ``in_specs``.  The port's 4 gloo ranks
run the registry's cells for the same configs on their blocks of the same
numpy-seeded weights and batches.  Cases: the four models' train, serve
and retrieval cells on (2, 2) and FM's on (1, 4).

Tolerances (f32): the loss, the moments after the step and the scores
within 1e-5 of the largest magnitude of the reference's value; the updated
parameters within 1e-6 of the one-rank AdamW on the assembled gradient (as
``tests/test_torch_tp.py``); lookups bit for bit.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.dist.sharding import P, from_shards, local_shard
from repro_torch.dist.step import shard_tree
from repro_torch.launch.mesh import Mesh, init_rank_mesh, spawn_ranks
from repro_torch.models import recsys as R
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.tree import flatten, unflatten


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
TOL = 1e-5
BIG = 70_000
#: each model's reduced config's fields replaced so that one table is big
WIDEN = {"fm": dict(vocab_sizes=(BIG, 60, 70, 80, 90)), "sasrec": dict(n_items=BIG),
         "autoint": dict(vocab_sizes=(BIG, 60, 70, 80, 90)),
         "dlrm-mlperf": dict(vocab_sizes=(BIG, 200, 300, 400))}
ARCHS = tuple(WIDEN)
SHAPES = ("train_batch", "serve_p99", "retrieval_cand")
#: (arch, registry shape, mesh shape)
CASES = [(a, s, (2, 2)) for a in ARCHS for s in SHAPES] + [("fm", s, (1, 4)) for s in SHAPES]
IDS = [f"{a}-{s}-{m[0]}x{m[1]}" for a, s, m in CASES]
B, N = 8, 64  # the registry's reduced batch and candidates

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import registry as reg

inp = np.load(sys.argv[1])
cases, widen = eval(sys.argv[3]), eval(sys.argv[4])
for arch, kw in widen.items():
    mod = reg.get_arch_module(arch)
    cfg = dataclasses.replace(mod.reduced_config(), **kw)
    mod.reduced_config = lambda cfg=cfg: cfg


def arrays(prefix, like):
    treedef = jax.tree.structure(like)
    return jax.tree.unflatten(treedef, [inp[f"{prefix}{i}"] for i in range(treedef.num_leaves)])


out = {}
for i, (arch, shape, mshape) in cases.items():
    mesh = jax.make_mesh(mshape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cell = reg.build_cell(arch, shape, mesh, reduced=True)
    args = [arrays(f"{arch}_p", cell.abstract_args[0])]
    if cell.kind == "train":
        zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), cell.abstract_args[1])
        args += [zeros, arrays(f"{arch}_train_", cell.abstract_args[2])]
    elif cell.kind == "serve":
        args += [arrays(f"{arch}_serve_", cell.abstract_args[1])]
    else:
        args += [inp[f"{arch}_retr_{k}"] for k in range(len(cell.abstract_args) - 1)]
    shard = jax.tree.map(lambda s: NamedSharding(mesh, s), cell.in_specs,
                         is_leaf=lambda s: isinstance(s, P))
    with mesh:
        res = jax.jit(cell.step_fn)(*jax.device_put(tuple(args), tuple(shard)))
    if cell.kind == "train":
        out[f"c{i}_loss"] = res[2]
        for j, leaf in enumerate(jax.tree.leaves(res[1]["m"])):
            out[f"c{i}_m{j}"] = leaf
        for j, leaf in enumerate(jax.tree.leaves(res[1]["v"])):
            out[f"c{i}_v{j}"] = leaf
    else:
        out[f"c{i}_scores"] = res
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("REF_OK")
"""


def _config(arch):
    return dataclasses.replace(treg.get_arch_module(arch).reduced_config(), **WIDEN[arch])


@contextlib.contextmanager
def _widened():
    """The registry's reduced configs replaced by the wide ones while the
    block runs (the config modules are shared by the process's tests)."""
    mods = {arch: treg.get_arch_module(arch) for arch in ARCHS}
    saved = {arch: mod.reduced_config for arch, mod in mods.items()}
    try:
        for arch, mod in mods.items():
            cfg = dataclasses.replace(saved[arch](), **WIDEN[arch])
            mod.reduced_config = lambda cfg=cfg: cfg
        yield
    finally:
        for arch, mod in mods.items():
            mod.reduced_config = saved[arch]


def _batches(rng, arch, cfg):
    """Uniform ids over every table's rows (Zipf ids would stay in the first
    block): the train batch, the serve batch and the retrieval inputs."""
    if arch == "sasrec":
        seq = lambda b: rng.integers(0, cfg.n_items, (b, cfg.seq_len)).astype(np.int32)  # noqa: E731
        train = {"item_seq": seq(B), "label": (rng.random(B) < 0.3).astype(np.float32),
                 "neg_items": seq(B), "pos_items": seq(B)}
        serve = {"item_seq": seq(B), "target": rng.integers(1, cfg.n_items, B).astype(np.int32)}
        retr = [seq(1)]
    else:
        ids = lambda b: np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes],  # noqa: E731
                                 1).astype(np.int32)
        train = {"label": (rng.random(B) < 0.3).astype(np.float32), "sparse": ids(B)}
        serve = {"sparse": ids(B)}
        retr = [ids(1)[0]]
        if arch == "dlrm-mlperf":
            dense = lambda b: rng.standard_normal((b, cfg.n_dense)).astype(np.float32)  # noqa: E731
            train["dense"], serve["dense"] = dense(B), dense(B)
            retr = [dense(1)[0]] + retr
    first = cfg.n_items if arch == "sasrec" else cfg.vocab_sizes[0]
    retr.append(rng.integers(0, first, N).astype(np.int32))
    return train, serve, retr


def _inputs():
    rng = np.random.default_rng(5)
    arrays = {}
    for arch in ARCHS:
        cfg = _config(arch)
        init = treg.RECSYS[arch][0]
        for i, s in enumerate(flatten(init(cfg, None, device="meta"))[0]):
            arrays[f"{arch}_p{i}"] = np.asarray(rng.standard_normal(tuple(s.shape)) * 0.1,
                                                np.float32)
        train, serve, retr = _batches(rng, arch, cfg)
        for name, b in (("train", train), ("serve", serve)):
            for i, k in enumerate(sorted(b)):
                arrays[f"{arch}_{name}_{i}"] = b[k]
        for k, x in enumerate(retr):
            arrays[f"{arch}_retr_{k}"] = x
    return arrays


def _tree(inp, prefix, like):
    leaves = flatten(like)[0]
    return unflatten(like, [torch.from_numpy(inp[f"{prefix}{i}"]) for i in range(len(leaves))])


def _lookup_checks(mesh):
    """Sharded lookups against ``table[ids]`` bit for bit, f32 and bf16, ids
    at every block edge, both the psum and the spread path."""
    out = []
    rows = 70_656
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn(rows, 12, generator=gen).to(dtype)
        n = rows // mesh.group_size("model")
        rows_of = local_shard(table, P("model", None), mesh.shape,
                              dict(zip(AXES, mesh.coords))).contiguous()
        block, spread_block = R.RowBlock(rows_of, mesh), R.RowBlock(rows_of, mesh, spread=True)
        edges = sorted({max(0, min(rows - 1, b * n + d)) for b in range(5) for d in (-1, 0, 1)})
        edges += [12_345] * (-len(edges) % 4)
        ids = torch.tensor(edges, dtype=torch.int32).reshape(-1, 2)
        got = R.lookup(block, ids)
        with torch.no_grad():
            mine = ids.reshape(-1)[mesh.group_rank("model")::mesh.group_size("model")]
            spread = R.lookup(spread_block, mine)
        out.append(torch.equal(got, table[ids.long()]) and torch.equal(spread, table[mine.long()]))
    return out


def _port_rank(mesh, path):
    with _widened():
        return _port_cases(mesh, path)


def _port_cases(mesh, path):
    inp = dict(np.load(path))
    meshes = {mesh.mesh.sizes: mesh}
    out = {"cases": [], "lookups": _lookup_checks(mesh)}
    for arch, shape, mshape in CASES:
        if mshape not in meshes:
            meshes[mshape] = init_rank_mesh(mshape, AXES, "gloo", "cpu")
        rm = meshes[mshape]
        cell = treg.build_cell(arch, shape, reduced=True, mesh=rm)
        full = _tree(inp, f"{arch}_p", cell.abstract_args[0])
        params = shard_tree(full, cell.in_specs[0], rm)
        if cell.kind == "train":
            batch = shard_tree(_tree(inp, f"{arch}_train_", cell.abstract_args[2]),
                               cell.in_specs[2], rm)
            opt = shard_tree(adamw_init(full), cell.in_specs[1], rm)
            newp, newo, loss = cell.step_fn(params, opt, batch)
            out["cases"].append({"loss": float(loss), "params": flatten(newp)[0],
                                 "m": flatten(newo["m"])[0], "v": flatten(newo["v"])[0]})
            continue
        if cell.kind == "serve":
            args = [shard_tree(_tree(inp, f"{arch}_serve_", cell.abstract_args[1]),
                               cell.in_specs[1], rm)]
        else:
            args = [local_shard(torch.from_numpy(inp[f"{arch}_retr_{k}"]), s, rm.shape,
                                dict(zip(AXES, rm.coords)))
                    for k, s in enumerate(cell.in_specs[1:])]
        with torch.no_grad():
            out["cases"].append({"scores": cell.step_fn(params, *args)})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rows")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    parts = [{i: c for i, c in enumerate(CASES) if c[0] in ("fm", "sasrec")},
             {i: c for i, c in enumerate(CASES) if c[0] not in ("fm", "sasrec")}]
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REF, str(d / "in.npz"), str(d / f"ref{k}.npz"), repr(part),
         repr(WIDEN)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, part in enumerate(parts)]
    try:
        port = spawn_ranks(_port_rank, (2, 2), "gloo", "cpu", args=(str(d / "in.npz"),),
                           axes=AXES, timeout_s=300)
    finally:
        done = [p.communicate(timeout=600) for p in refs]
    ref = {}
    for k, p in enumerate(refs):
        assert p.returncode == 0 and "REF_OK" in done[k][0], done[k][1][-3000:]
        ref.update(np.load(d / f"ref{k}.npz"))
    return inp, ref, port


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _cell(i):
    arch, shape, mshape = CASES[i]
    mesh = Mesh(AXES, mshape)
    with _widened():
        return treg.build_cell(arch, shape, reduced=True, mesh=mesh), mesh


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_cell_matches_the_reference(runs, i):
    """Train: the loss on every rank and the moments after one ZeRO-1
    step; serve and retrieval: the scores, put back together by the cell's
    ``out_specs``."""
    _, ref, port = runs
    cell, mesh = _cell(i)
    got = [r["cases"][i] for r in port[:mesh.size]]
    if cell.kind != "train":
        _close(from_shards([g["scores"] for g in got], cell.out_specs, mesh), ref[f"c{i}_scores"])
        return
    loss = float(ref[f"c{i}_loss"])
    assert all(abs(g["loss"] - loss) <= TOL * abs(loss) for g in got)
    for key in ("m", "v"):
        for j, spec in enumerate(flatten(cell.in_specs[1][key])[0]):
            _close(from_shards([g[key][j] for g in got], spec, mesh), ref[f"c{i}_{key}{j}"])


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES) if c[1] == "train_batch"],
                         ids=[IDS[i] for i, c in enumerate(CASES) if c[1] == "train_batch"])
def test_train_step_is_adamw_on_the_mean_gradient(runs, i):
    """The updated parameters, put back together, are the one-rank AdamW
    step on the gradient the moments hold (m = (1 - b1) g at the first
    step)."""
    inp, _, port = runs
    cell, mesh = _cell(i)
    got = [r["cases"][i] for r in port[:mesh.size]]
    full = _tree(inp, f"{CASES[i][0]}_p", cell.abstract_args[0])
    opt = AdamWConfig()
    m = [from_shards([g["m"][j] for g in got], s, mesh)
         for j, s in enumerate(flatten(cell.in_specs[1]["m"])[0])]
    grads = unflatten(full, [x / (1 - opt.b1) for x in m])
    want, _ = adamw_update(dataclasses.replace(opt, grad_clip=None), full, grads,
                           adamw_init(full))
    for j, spec in enumerate(flatten(cell.in_specs[0])[0]):
        _close(from_shards([g["params"][j] for g in got], spec, mesh), flatten(want)[0][j], 1e-6)


def test_some_table_is_row_sharded():
    for arch in ARCHS:
        cell, _ = _cell(CASES.index((arch, "serve_p99", (2, 2))))
        assert P("model", None) in flatten(cell.in_specs[0])[0], arch


def test_sharded_lookups_are_the_whole_tables_rows(runs):
    for r in runs[2]:
        assert r["lookups"] == [True, True]


def test_cpu_mask_keeps_c12_on_whole_tables():
    """On the CPU a whole table's negative id still counts from the end
    (ROADMAP C12); a row block masks every id outside it instead of letting
    a negative local id wrap."""

    class _Rank:
        def group_rank(self, role):
            return 1

    table = torch.arange(40.0).reshape(8, 5)
    assert torch.equal(R.lookup(table, torch.tensor([-1])), table[[7]])
    block = R.RowBlock(table[4:], _Rank())
    got = block.local_rows(torch.tensor([0, 3, 4, 7, -1, 8]))
    want = torch.stack([torch.zeros(5), torch.zeros(5), table[4], table[7], torch.zeros(5),
                        torch.zeros(5)])
    assert torch.equal(got, want)
