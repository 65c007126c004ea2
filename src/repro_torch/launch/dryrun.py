"""Dry run of every (architecture x input shape) cell on the ``meta``
device (counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--out F]

For each cell of ``configs.registry``: build it (abstract inputs as
``meta`` tensors) and run its step function once on them.  PyTorch's meta
kernels propagate shapes and dtypes without memory or arithmetic, so a
run proves that every shape in the step agrees, as the reference's
``lower().compile()`` does on its TPU mesh.  The kernel wrappers take
their plain versions on non-CUDA tensors, and a meta tensor launches
nothing, so no kernel is hidden from the card by this.  An op without a
meta implementation, or a host read (``.item()``, a tensor's truth
value), raises, and the cell is reported as failed with its reason.

For each cell it reports, on one card:
  * the state bytes: every abstract input (parameters, optimizer moments,
    batch, KV cache);
  * the reference's analytic estimate of the device's bytes: the state
    plus a live window of 15% of the cell's analytic bytes;
  * ``roofline_terms`` at ``chips=1`` on H100 constants (no collective);
  * whether the estimate fits one 80 GB card.

and on each production mesh (``16x16``, ``pod2x16x16``), from the cell's
partition specs there, the reference's per-device arithmetic
(``repro.launch.dryrun``): each input leaf's bytes over the ranks its spec
splits it across, plus the live window of the analytic bytes over the
chips.  ``needs`` is the card count those bytes need: one card where the
one-card estimate fits, else the smaller production mesh whose per-device
estimate fits an 80 GB card.  A cell that needs several cards is not a
failure.  For every cell it also reports, on each production mesh, the
bytes one rank's collectives send in one call of the per-rank program the
port runs there, counted from the cell's shapes and specs by
``dist.roofline`` (``collective_term``: ``tp_train_bytes``,
``tp_prefill_bytes`` or ``tp_decode_bytes`` on the rank's rows for an LM
cell, ``recsys_bytes`` on its requests or candidates, ``gnn_bytes``: 0
for the replicated ``full_graph_sm``), and the roofline at that mesh's
card count with them as its collective term.  These are the port's own
layouts' bytes, not the reference's HLO counts.

The exit code is 1 if any cell failed.  No card is needed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs.registry import ALL_ARCHS, ARCH_SHAPES, build_cell, get_arch_module
from repro_torch.dist.roofline import (
    gnn_bytes,
    recsys_bytes,
    roofline_terms,
    tp_decode_bytes,
    tp_prefill_bytes,
    tp_train_bytes,
)
from repro_torch.dist.sharding import P, is_spec, shard_count
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train.tree import flatten

#: one H100's device memory (the 80 GB part)
HBM_BYTES = 80e9
#: the reference's share of a cell's analytic bytes live at once
LIVE_WINDOW = 0.15


def _leaves(args) -> list:
    return [leaf for arg in args for leaf in flatten(arg)[0]]


def per_device_bytes(cell, mesh) -> dict:
    """The reference's per-device memory model of ``cell`` (built on
    ``mesh``): state bytes (each input leaf's bytes, integer-divided by the
    ranks its spec splits it across) and the live window of the analytic
    bytes over the chips."""
    state = 0
    for tree, specs in zip(cell.abstract_args, cell.in_specs):
        leaves = flatten(tree)[0]
        spec_leaves = [specs] if is_spec(specs) else flatten(specs)[0]  # a spec is a leaf
        if len(leaves) != len(spec_leaves):
            raise ValueError(f"{cell.arch} {cell.shape}: {len(leaves)} inputs, "
                             f"{len(spec_leaves)} specs")
        for ab, spec in zip(leaves, spec_leaves):
            state += ab.numel() * ab.element_size() // max(shard_count(spec, mesh), 1)
    act = cell.meta.get("analytic_bytes", 0) / mesh.size * LIVE_WINDOW
    return {"chips": mesh.size, "analytic_state_mb": state / 2**20,
            "analytic_device_mb": (state + act) / 2**20,
            "fits_80gb": state + act <= HBM_BYTES}


PRODUCTION_MESHES = {"16x16": False, "pod2x16x16": True}


def _rows(x, spec, mesh) -> int:
    """A rank's share of ``x``'s leading dimension under ``spec``."""
    return x.shape[0] // shard_count(P(spec[0]) if len(spec) else P(), mesh)


def collective_term(cell, mesh, reduced: bool) -> dict:
    """Any cell (built on ``mesh``): the bytes a rank sends in one call of
    its step there (module docstring) and the roofline on ``mesh.size``
    cards with them."""
    mod = get_arch_module(cell.arch)
    args, specs = cell.abstract_args, cell.in_specs
    if mod.FAMILY == "gnn":
        nbytes = gnn_bytes(mesh, args[0], args[2], specs[2])
    else:
        cfg = mod.reduced_config() if reduced else mod.config()
        if mod.FAMILY == "recsys":
            rows = (_rows(args[-1], specs[-1], mesh) if cell.kind == "retrieval" else
                    _rows(*(flatten(x)[0][0] for x in (args[-1], specs[-1])), mesh))
            nbytes = recsys_bytes(cell.kind, cfg, mesh, args[0], specs[0], rows,
                                  specs[1]["m"] if cell.kind == "train" else None)
        elif cell.kind == "train":
            B, S = args[2]["tokens"].shape
            dp = mesh.size // mesh.shape[mesh.model_axis]
            nbytes = tp_train_bytes(cfg, mesh, specs[0], specs[1]["m"], (B // dp, S))
        elif cell.kind == "prefill":
            nbytes = tp_prefill_bytes(cfg, mesh, specs[0], (_rows(args[1], specs[1], mesh),
                                                            args[1].shape[1]))
        else:
            nbytes = tp_decode_bytes(cfg, mesh, specs[0], _rows(args[1], specs[1], mesh))
    return {"chips": mesh.size, "bytes_a_rank": nbytes,
            "roofline": roofline_terms(cell.meta, mesh.size, nbytes).row()}


def run_cell(arch: str, shape: str, reduced: bool = False, verbose: bool = True) -> dict:
    """Build one cell, run its step on the meta device and report it;
    raises whatever the step raises."""
    cell = build_cell(arch, shape, reduced=reduced)
    t0 = time.perf_counter()
    out = cell.step_fn(*cell.abstract_args)
    step_s = time.perf_counter() - t0
    outs = _leaves(out if isinstance(out, tuple) else (out,))
    if not all(isinstance(x, torch.Tensor) and x.is_meta for x in outs):
        raise RuntimeError(f"{arch} {shape}: the step returned a value that is not a meta "
                           "tensor")

    state = sum(x.numel() * x.element_size() for x in _leaves(cell.abstract_args))
    live = cell.meta["analytic_bytes"] * LIVE_WINDOW
    fits = state + live <= HBM_BYTES
    rl = roofline_terms(cell.meta, 1, 0.0)
    production, collective = {}, {}
    for label, multi in PRODUCTION_MESHES.items():
        pmesh = make_production_mesh(multi_pod=multi)
        pcell = build_cell(arch, shape, reduced=reduced, mesh=pmesh)
        production[label] = per_device_bytes(pcell, pmesh)
        collective[label] = collective_term(pcell, pmesh, reduced)
    if fits:
        needs = "1 card"
    else:
        fitting = [p for p in production.values() if p["fits_80gb"]]
        needs = (f"{min(p['chips'] for p in fitting)} cards" if fitting
                 else f"more than {max(p['chips'] for p in production.values())} cards")
    result = {
        "arch": arch,
        "shape": shape,
        "kind": cell.kind,
        "reduced": reduced,
        "chips": 1,
        "meta_run_host_s": step_s,
        "memory": {
            "state_mb": state / 2**20,
            "analytic_live_mb": live / 2**20,
            "analytic_device_mb": (state + live) / 2**20,
            "fits_one_card": fits,
        },
        "production": production,
        "collective": collective,
        "needs": needs,
        "roofline": rl.row(),
        "meta": {k: cell.meta[k] for k in ("params_total", "params_active", "tokens",
                                           "scan_trips")},
    }
    if verbose:
        print(f"[OK] {arch:26s} {shape:14s} state={state / 1e9:9.3f} GB "
              f"device~{(state + live) / 1e9:9.3f} GB {result['needs']:22s} "
              f"16x16 {production['16x16']['analytic_device_mb'] / 1024:8.2f} GiB/dev "
              f"dom={rl.dominant} c/m/x = {rl.compute_s:.3e}/{rl.memory_s:.3e}/"
              f"{rl.collective_s:.3e} s (meta run {step_s:.2f} s)", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ALL_ARCHS))
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ALL_ARCHS)
    results, failures = [], []
    for arch in archs:
        for shape in [args.shape] if args.shape else ARCH_SHAPES[arch]:
            try:
                results.append(run_cell(arch, shape))
            except Exception as e:  # noqa: BLE001 - a failed cell is reported, the rest run
                failures.append({"arch": arch, "shape": shape,
                                 "error": f"{type(e).__name__}: {e}"})
                print(f"[FAIL] {arch} {shape}: {type(e).__name__}: {e}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1)
    several = sum(not r["memory"]["fits_one_card"] for r in results)
    print(f"\n{len(results)} cells OK ({several} need several cards), "
          f"{len(failures)} failures" + (f" -> {args.out}" if args.out else ""))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
