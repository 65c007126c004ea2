"""The port's cell registry (``repro_torch.configs.registry``), roofline
(``repro_torch.dist.roofline``) and dry run (``repro_torch.launch.dryrun``)
against the reference's, on the CPU.

* The shape tables and the 40 cells are the reference's.
* Every cell's ``meta`` (the analytic FLOP and byte models, parameter
  counts, tokens, scan trips) equals the reference's number for number,
  full and reduced; the reference's cells are built on its one-device host
  mesh (``repro.launch.mesh.make_host_mesh``).
* Every cell's abstract inputs carry the reference's shapes and dtypes,
  leaf for leaf in ``jax.tree.leaves``' order (the partitioned NequIP
  cells excepted: the port takes their dense layout on one card).
* The reduced ``smollm-135m``, ``fm`` and ``nequip`` train cells take one
  real step on the CPU (the LM on a batch of 2 x 64 tokens: the cell keeps
  ``train_4k``'s 256 x 4,096, which is for the meta device).
* The dry run passes on every reduced cell and on one full cell per family.
* ``roofline_terms`` against a computation by hand at the H100 constants.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_host_mesh
from repro_torch.configs import registry as treg
from repro_torch.data.pipelines import lm_batches, random_graph, recsys_batches
from repro_torch.dist import roofline
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import nequip, recsys, transformer
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.tree import flatten


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]


def test_shape_tables_match_the_reference():
    assert treg.ALL_ARCHS == jreg.ALL_ARCHS
    assert treg.LM_SHAPES == jreg.LM_SHAPES
    assert treg.GNN_SHAPES == jreg.GNN_SHAPES
    assert treg.RECSYS_SHAPES == jreg.RECSYS_SHAPES
    assert treg.ARCH_SHAPES == jreg.ARCH_SHAPES
    cells = list(treg.all_cells())
    assert cells == list(jreg.all_cells()) and len(cells) == 40
    with pytest.raises(KeyError):
        treg.build_cell("gpt-5", "train_4k")
    with pytest.raises(KeyError, match="no shape"):
        treg.build_cell("fm", "train_4k")


def _port_leaves(args):
    return [leaf for arg in args for leaf in flatten(arg)[0]]


@pytest.mark.parametrize("arch", jreg.ALL_ARCHS)
def test_cells_match_the_reference(arch):
    mesh = make_host_mesh()
    for shape in jreg.ARCH_SHAPES[arch]:
        for reduced in (False, True):
            want = jreg.build_cell(arch, shape, mesh, reduced=reduced)
            got = treg.build_cell(arch, shape, reduced=reduced)
            where = (arch, shape, reduced)
            assert (got.arch, got.shape, got.kind) == (want.arch, want.shape, want.kind), where
            assert got.meta == want.meta, where
            assert all(type(v) is type(want.meta[k]) for k, v in got.meta.items()), where
            leaves = _port_leaves(got.abstract_args)
            assert all(x.is_meta for x in leaves), where
            if "edge_src" in str(jax.tree.structure(want.abstract_args)):
                continue  # the partitioned layout: dense on one card
            ref = jax.tree.leaves(want.abstract_args)
            assert [(tuple(x.shape), str(x.dtype).removeprefix("torch.")) for x in leaves] == [
                (tuple(x.shape), str(x.dtype)) for x in ref], where


def _real_args(arch, cell):
    """Real CPU inputs for a reduced train cell: the model's own init, the
    family's pipeline (the LM's batch cut to 2 x 64)."""
    cfg = treg.get_arch_module(arch).reduced_config()
    gen = torch.Generator().manual_seed(0)
    if arch == "smollm-135m":
        params = transformer.init_params(cfg, gen, device="cpu")
        batch = next(lm_batches(cfg.vocab, 2, 64))
    elif arch == "nequip":
        params = nequip.init_params(cfg, gen, device="cpu")
        batch = random_graph(64, 128, cfg.d_feat_in, n_graphs=4)
    else:
        params = recsys.fm_init(cfg, gen, device="cpu")
        batch = next(recsys_batches(cfg.vocab_sizes, 8))
    like = _port_leaves(cell.abstract_args[:1])
    assert [(x.shape, x.dtype) for x in flatten(params)[0]] == [(x.shape, x.dtype) for x in like]
    return params, adamw_init(params), {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["smollm-135m", "fm", "nequip"])
def test_reduced_train_cell_takes_a_real_step(arch):
    shape = treg.ARCH_SHAPES[arch][0]
    cell = treg.build_cell(arch, shape, reduced=True)
    assert cell.kind == "train"
    params, opt, batch = _real_args(arch, cell)
    new_params, new_opt, loss = cell.step_fn(params, opt, batch)
    assert loss.shape == () and torch.isfinite(loss)
    assert int(new_opt["step"]) == 1
    before, after = flatten(params)[0], flatten(new_params)[0]
    assert [x.shape for x in after] == [x.shape for x in before]
    assert all(torch.isfinite(x).all() for x in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


def test_dryrun_passes_on_every_reduced_cell():
    for arch, shape in treg.all_cells():
        r = dryrun.run_cell(arch, shape, reduced=True, verbose=False)
        assert (r["arch"], r["shape"], r["reduced"], r["chips"]) == (arch, shape, True, 1)
        assert r["memory"]["fits_one_card"] and r["roofline"]["collective_s"] == 0.0


def test_dryrun_cli_writes_its_report(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "nequip", "--shape", "molecule", "--out", str(out)]) == 0
    assert "1 cells OK (0 need several cards), 0 failures" in capsys.readouterr().out
    report = json.loads(out.read_text())
    assert not report["failures"]
    assert [(r["arch"], r["shape"]) for r in report["results"]] == [("nequip", "molecule")]


@pytest.mark.parametrize("arch,shape,fits", [("smollm-135m", "long_500k", True),
                                             ("nequip", "ogb_products", False),
                                             ("dlrm-mlperf", "serve_p99", True)])
def test_dryrun_full_cell(arch, shape, fits):
    r = dryrun.run_cell(arch, shape, verbose=False)
    cell = treg.build_cell(arch, shape)
    state = sum(x.numel() * x.element_size() for x in _port_leaves(cell.abstract_args))
    assert r["memory"]["state_mb"] == state / 2**20
    live = cell.meta["analytic_bytes"] * dryrun.LIVE_WINDOW
    assert r["memory"]["analytic_device_mb"] == (state + live) / 2**20
    assert r["memory"]["fits_one_card"] is fits
    assert r["needs"] == ("1 card" if fits else "256 cards")
    assert r["production"]["16x16"] == dryrun.per_device_bytes(
        treg.build_cell(arch, shape, mesh=make_production_mesh()), make_production_mesh())
    assert r["roofline"] == roofline.roofline_terms(cell.meta, 1, 0.0).row()


def test_dryrun_reports_a_failing_cell(monkeypatch, capsys):
    def sync(*args):
        return torch.zeros((), device="meta").item()

    real = treg.build_cell

    def build(arch, shape, reduced=False, mesh=None):
        cell = real(arch, shape, reduced=reduced, mesh=mesh)
        cell.step_fn = sync
        return cell

    monkeypatch.setattr(dryrun, "build_cell", build)
    assert dryrun.main(["--arch", "fm", "--shape", "serve_p99"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] fm serve_p99" in out and "0 cells OK" in out and "1 failures" in out


def test_roofline_terms_by_hand():
    meta = {"model_flops": 2.0e15, "analytic_flops": 4.0e15, "analytic_bytes": 3.0e12}
    t = roofline.roofline_terms(meta, 2, 9.0e9)
    assert t.compute_s == pytest.approx(4.0e15 / (2 * 989.4e12), rel=1e-15)
    assert t.memory_s == pytest.approx(3.0e12 / (2 * 3.35e12), rel=1e-15)
    assert t.collective_s == pytest.approx(9.0e9 / 450e9, rel=1e-15)
    assert t.dominant == "compute" and t.useful_ratio == 0.5
    assert t.row() == {"compute_s": t.compute_s, "memory_s": t.memory_s,
                       "collective_s": t.collective_s, "dominant": "compute",
                       "model_flops": 2.0e15, "analytic_flops": 4.0e15, "useful_ratio": 0.5}
    # a measured count above the analytic one is used, as the reference does
    t = roofline.roofline_terms(meta, 1, 0.0, raw_flops=8.0e15, raw_bytes=1.0e14)
    assert t.analytic_flops == 8.0e15 and t.useful_ratio == 0.25
    assert t.memory_s == pytest.approx(1.0e14 / 3.35e12, rel=1e-15) and t.dominant == "memory"
    assert roofline.roofline_terms({}, 0, 0.0).useful_ratio == 0.0


def test_no_tpu_constant_in_the_port():
    """The reference's TPU v5e peaks appear nowhere in the port."""
    from repro.dist import roofline as jroof

    consts = {repr(x) for x in (jroof.PEAK_FLOPS, jroof.PEAK_HBM_BPS, jroof.PEAK_ICI_BPS)}
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        text = path.read_text()
        assert "v5e" not in text, path
        assert not [c for c in consts if c in text], path
    assert np.isclose(roofline.H100_PEAK_BF16_FLOPS, 989.4e12)
