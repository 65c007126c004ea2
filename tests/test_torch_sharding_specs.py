"""The partition specs (``repro_torch.dist.sharding``), the registry's
``in_specs``/``out_specs`` and the dry run's per-device bytes against the
reference's, and ``local_shard`` against the blocks JAX places, on the CPU.

* Every cell of the 40 on both production meshes, ``(data 16, model 16)``
  and ``(pod 2, data 16, model 16)``: the port's specs equal the
  reference's entry for entry (the reference's cells built on
  ``jax.sharding.AbstractMesh``, no devices), its abstract inputs carry the
  reference's shapes and dtypes (the partitioned NequIP layout included),
  and the dry run's per-device bytes equal the reference's arithmetic
  (``repro.launch.dryrun``) on the reference's cell.
* ``local_shard`` cuts, for each device of a real host mesh, the block JAX
  places on it under the same spec; the device's coordinates are read
  from ``mesh.devices``.  ``from_shards`` puts the blocks back together.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.dist import sharding as jsh
from repro_torch.configs import registry as treg
from repro_torch.dist import sharding as tsh
from repro_torch.dist.sharding import P
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.train.tree import flatten


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESHES = {"16x16": False, "pod2x16x16": True}


@functools.lru_cache(maxsize=None)
def _ref_mesh(multi):
    m = make_production_mesh(multi_pod=multi)
    return AbstractMesh(m.sizes, m.axis_names)


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def _port_spec_leaves(specs):
    """A cell's specs leaf by leaf: a spec is a leaf; a tuple of trees is
    walked tree by tree."""
    if tsh.is_spec(specs):
        return [specs]
    if isinstance(specs, tuple):
        return [leaf for tree in specs for leaf in _port_spec_leaves(tree)]
    return flatten(specs)[0]


def _ref_device_bytes(cell, mesh):
    """``repro.launch.dryrun``'s per-device state and live window."""
    state = 0
    for tree, specs in zip(cell.abstract_args, cell.in_specs):
        for ab, spec in zip(jax.tree.leaves(tree), _ref_leaves(specs)):
            shard = 1
            for entry in spec or ():
                if entry is None:
                    continue
                for ax in entry if isinstance(entry, tuple) else (entry,):
                    shard *= mesh.shape[ax]
            state += int(np.prod(ab.shape)) * ab.dtype.itemsize // max(shard, 1)
    act = cell.meta.get("analytic_bytes", 0) / mesh.size * 0.15
    return state / 2**20, (state + act) / 2**20


@pytest.mark.parametrize("arch", jreg.ALL_ARCHS)
def test_specs_match_the_reference_on_production_meshes(arch):
    for label, multi in MESHES.items():
        jm, tm = _ref_mesh(multi), make_production_mesh(multi_pod=multi)
        for shape in jreg.ARCH_SHAPES[arch]:
            want = jreg.build_cell(arch, shape, jm)
            got = treg.build_cell(arch, shape, mesh=tm)
            where = (arch, shape, label)
            for part in ("in_specs", "out_specs"):
                w = [tuple(s) for s in _ref_leaves(getattr(want, part))]
                g = [tuple(s) for s in _port_spec_leaves(getattr(got, part))]
                assert g == w, (where, part)
            w = jax.tree.leaves(want.abstract_args)
            g = [leaf for arg in got.abstract_args for leaf in flatten(arg)[0]]
            assert [tuple(x.shape) for x in g] == [tuple(x.shape) for x in w], where
            assert [str(x.dtype).replace("torch.", "") for x in g] == [str(x.dtype) for x in w]
            port = dryrun.per_device_bytes(got, tm)
            ref_state, ref_dev = _ref_device_bytes(want, jm)
            assert port["analytic_state_mb"] == ref_state, where
            assert port["analytic_device_mb"] == pytest.approx(ref_dev, rel=1e-12), where
            assert port["chips"] == jm.size


def test_spec_rules_match_the_reference():
    """``zero_spec_for``, ``axes_for_mesh``, ``nequip_batch_specs`` and the
    KV cache's specs on meshes where the guards bite."""
    for multi in (False, True):
        jm, tm = _ref_mesh(multi), make_production_mesh(multi_pod=multi)
        ja, ta = jsh.axes_for_mesh(jm), tsh.axes_for_mesh(tm)
        assert (ta.dp, ta.mdl, ta.all_axes) == (ja.dp, ja.mdl, ja.all_axes)
        dpn = tsh.dp_size(tm, ta)
        assert dpn == jsh.dp_size(jm, ja)
        for spec, shape in [((None, "model"), (16, 32)), ((), (48, 7)), ((None,), (5, 32)),
                            (("model",), (64, 64)), ((("pod", "data"),), (64, 8))]:
            got = tsh.zero_spec_for(P(*spec), shape, ta, dpn)
            assert tuple(got) == tuple(jsh.zero_spec_for(JP(*spec), shape, ja, dpn))
        for shard in (True, False):
            got = tsh.nequip_batch_specs(ta, shard)
            want = jsh.nequip_batch_specs(ja, shard)
            assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
        for arch in ("llama4-scout-17b-a16e", "smollm-135m"):
            tcfg, jcfg = treg.get_arch_module(arch).config(), jreg.get_arch_module(arch).config()
            for batch in (1, 128):
                got = tsh.lm_cache_specs(tcfg, ta, batch, tm)
                want = jsh.lm_cache_specs(jcfg, ja, batch, jm)
                assert {k: {n: tuple(x) for n, x in v.items()} for k, v in got.items()} == \
                    {k: {n: tuple(x) for n, x in v.items()} for k, v in want.items()}
    host = make_host_mesh()
    assert (host.sizes, host.axis_names) == ((1, 1), ("data", "model"))


SPECS = [P("data", None), P(None, "model"), P(("data", "model")), P("model", "data"),
         P(None, ("model", "data")), P(), P(None, None, "data")]


@pytest.mark.parametrize("spec", SPECS, ids=[str(tuple(s)) for s in SPECS])
def test_local_shard_cuts_the_blocks_jax_places(spec):
    devices = np.array(jax.devices()[:4])
    jm = jax.make_mesh((2, 2), ("data", "model"), devices=devices)
    tm = Mesh(("data", "model"), (2, 2))
    x = np.arange(8 * 12 * 4, dtype=np.float32).reshape(8, 12, 4)
    arr = jax.device_put(x, NamedSharding(jm, JP(*spec)))
    blocks = {}
    for shard in arr.addressable_shards:
        pos = np.argwhere(jm.devices == shard.device)[0]
        coords = dict(zip(jm.axis_names, (int(c) for c in pos)))
        got = tsh.local_shard(torch.from_numpy(x), spec, tm.shape, coords)
        assert np.array_equal(got.numpy(), np.asarray(shard.data)), coords
        blocks[tm.rank_of(tuple(pos))] = got
    back = tsh.from_shards([blocks[r] for r in range(4)], spec, tm)
    assert np.array_equal(back.numpy(), x)


def test_local_shard_on_three_axes_and_its_errors():
    devices = np.array(jax.devices()[:8])
    jm = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=devices)
    tm = Mesh(("pod", "data", "model"), (2, 2, 2))
    x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    spec = P(("pod", "data"), "model")
    arr = jax.device_put(x, NamedSharding(jm, JP(*spec)))
    for shard in arr.addressable_shards:
        pos = np.argwhere(jm.devices == shard.device)[0]
        coords = dict(zip(jm.axis_names, (int(c) for c in pos)))
        got = tsh.local_shard(torch.from_numpy(x), spec, tm.shape, coords)
        assert np.array_equal(got.numpy(), np.asarray(shard.data))
    assert tm.coords(tm.rank_of((1, 0, 1))) == (1, 0, 1)
    with pytest.raises(ValueError, match="does not split"):
        tsh.local_shard(torch.zeros(6, 4), P("data"), {"data": 4}, {"data": 0})
    with pytest.raises(ValueError, match="more entries"):
        tsh.local_shard(torch.zeros(4), P("data", None), {"data": 2}, {"data": 0})


def test_multi_rank_cells_run_only_on_ranks():
    """On a description of several ranks the expert-parallel and
    partitioned steps refuse to run; one-rank cells keep the dense layout."""
    for arch, shape in [("llama4-scout-17b-a16e", "train_4k"), ("nequip", "minibatch_lg")]:
        cell = treg.build_cell(arch, shape, reduced=False, mesh=make_production_mesh())
        with pytest.raises(RuntimeError, match="started world"):
            cell.step_fn(*cell.abstract_args)
    one = treg.build_cell("nequip", "minibatch_lg")
    assert "edge_index" in one.abstract_args[2]
    assert tuple(one.in_specs[2]["edge_index"]) == (None, ("data", "model"))
