"""Check the embedding-bag kernel at the main path's shapes and time it in
turns beside other builds of it and beside PyTorch's gathers.

    python3 scripts/embedding_bag_ab.py [--other DIR ...] [--cases GROUP ...] [--reps N]

Case groups, each made on the card from a seed:

- ``phase6``: ``chip_smoke.py``'s phase 6, a 39,979,771 x 128 table in f32
  and bf16, bags of B = 65,536 and 512 of L = 1 and 1..32 (``sum``);
- ``narrow``: 39,979,771 x D tables in bf16, D = 1, 10, 16 and 50, at the
  registry's 262,144 x 39 uniform ids as bags of one;
- ``recsys``: each recsys model's bulk batch (262,144 rows; phase 12's ids)
  on every big table of its serving copy (FM's D = 10 and D = 1, SASRec's
  items, AutoInt's, DLRM's 48 GB).

Every build of ``model_kernels.cu`` (this tree's, labelled ``this``, and
each ``--other`` checkout's, labelled by its directory's name), each
compiled by its own ``nvcc``, all started together, is called through
``rt_embedding_bag`` and held to ``embedding_bag_plain`` (f32 within
``BAG_F32_TOL``, bf16 within 2 ulps; bags of one bit for bit equal to
``table[ids]``).  Then all are timed in turns (the builds, then reversed) by
CUDA events around calls queued behind a spin kernel, beside
``chip_smoke.bag_library_calls`` (``F.embedding_bag``; for bags of one
``table[ids]`` and ``torch.index_select``), with the byte and sector bounds
of ``chip_smoke.bag_bounds_ms``.  Prints the card's name
and power limit, each build's ptxas report, and one JSON line of results
last.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from ab_build import build_libraries  # noqa: E402
from chip_smoke import (  # noqa: E402
    BAG_F32_TOL, BF16_ULPS, EMB_DIM, EMB_LOOKUP_IDS, EMB_NARROW_DIMS, EMB_ROWS, RECSYS_ARCHS,
    RECSYS_SERVE, bag_bounds_ms, bag_library_calls, bf16_ulps, big_tables, free_device_memory,
    max_abs, nvidia_smi_line, padded_bags, queued_time_ms, recsys_batch, recsys_ids, require,
    serving_copy,
)
from repro_torch.kernels.embedding_bag import embedding_bag_plain  # noqa: E402

LAUNCHERS = ("rt_embedding_bag",)
KERNELS = "model_kernels.cu"
#: names of the library calls in the printed results
LIBRARY = {"library": "F.embedding_bag", "gather": "table[ids]", "index_select": "index_select"}
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}

def bag_call(lib, table, bags, mean=False):
    """One launch of ``lib``'s ``rt_embedding_bag``: [B, D] in the table's
    type."""
    B, L = bags.shape
    out = torch.empty(B, table.shape[1], dtype=table.dtype, device=table.device)
    err = lib.rt_embedding_bag(table.data_ptr(), bags.data_ptr(), out.data_ptr(), B, L,
                               table.shape[1], int(mean), int(table.dtype == torch.bfloat16),
                               torch.cuda.current_stream(table.device).cuda_stream)
    require(err == 0, f"rt_embedding_bag returned {err}")
    return out


def check(label, got, table, bags, want):
    """``got`` against the plain version's ``want``; bags of one (every id
    in range here) also bit for bit against ``table[ids]``.  Returns the
    error read."""
    if bags.shape[1] == 1:
        require(torch.equal(got.view(BITS[table.dtype]),
                            table[bags[:, 0].long()].view(BITS[table.dtype])),
                (label, "bags of one != table[ids]"))
    if table.dtype == torch.float32:
        err = max_abs(got, want)
        require(torch.allclose(got, want, rtol=BAG_F32_TOL, atol=BAG_F32_TOL), (label, err))
        return {"max_abs": err}
    u = bf16_ulps(got, want)
    require(u <= BF16_ULPS, (label, "bf16 ulps", u))
    return {"bf16_ulps": u}


def run_case(label, table, bags, libs, reps, results):
    """Check every build on one case, then time them in turns beside the
    library calls."""
    torch.cuda.synchronize()
    want = embedding_bag_plain(table, bags)
    errs = {name: check((label, name), bag_call(lib, table, bags), table, bags, want)
            for name, lib in libs.items()}
    del want
    fns = {name: (lambda lib=lib: bag_call(lib, table, bags)) for name, lib in libs.items()}
    fns.update({LIBRARY[k]: fn for k, fn in bag_library_calls(table, bags).items()})
    keys = list(fns)
    times = {}
    for key in keys + keys[::-1]:
        times.setdefault(key, []).append(queued_time_ms(fns[key], reps))
    byte_ms, sector_ms = bag_bounds_ms(table, bags)
    results[label] = {"device_ms": times, "check": errs, "bound_ms": byte_ms,
                      "sector_bound_ms": sector_ms, "entries": int((bags >= 0).sum())}
    print(f"[ab] {label}: bound {byte_ms:.4f} ms (bytes), sectors {sector_ms:.4f} ms; "
          + "; ".join(f"{k} {' '.join(f'{x:.4f}' for x in v)}" for k, v in times.items())
          + f"; checks {json.dumps(errs)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", nargs="*", default=[], help="checkouts whose kernel to time beside")
    ap.add_argument("--cases", nargs="*", default=["phase6", "narrow", "recsys"],
                    choices=["phase6", "narrow", "recsys"])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("embedding_bag_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    print(f"[ab] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    results = {"device": smi, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [("this", os.path.join(ROOT, "src", "repro_torch", "csrc"), tmp)]
        jobs += [(os.path.basename(os.path.normpath(o)), os.path.join(o, "src", "repro_torch",
                                                                      "csrc"), tmp)
                 for o in args.other]
        libs = build_libraries(jobs, LAUNCHERS, "embedding_bag", source=KERNELS)
        gen = torch.Generator(device=dev).manual_seed(1)
        cases = results["cases"]
        if "phase6" in args.cases:
            t32 = torch.randn(EMB_ROWS, EMB_DIM, generator=gen, device=dev)
            for dt in ("f32", "bf16"):
                t = t32 if dt == "f32" else t32.to(torch.bfloat16)
                if dt == "bf16":
                    del t32
                for B in (65_536, 512):
                    for L in (1, 32):
                        bags = padded_bags(gen, EMB_ROWS, B, L, dev)
                        run_case(f"phase6 {dt} B={B} L={L}", t, bags, libs, args.reps, cases)
                del t
            free_device_memory()
        if "narrow" in args.cases:
            bags = padded_bags(gen, EMB_ROWS, EMB_LOOKUP_IDS, 1, dev)
            for D in EMB_NARROW_DIMS:
                t = torch.randn(EMB_ROWS, D, generator=gen, device=dev, dtype=torch.bfloat16)
                run_case(f"narrow bf16 D={D}", t, bags, libs, args.reps, cases)
                del t
            del bags
            free_device_memory()
        if "recsys" in args.cases:
            from repro_torch.configs.registry import get_arch_module
            from repro_torch.launch.train import RECSYS
            from repro_torch.models import recsys as R

            for arch in RECSYS_ARCHS:
                cfg = get_arch_module(arch).config()
                params = serving_copy(R, RECSYS[arch][0], cfg, gen, dev)
                ids = recsys_ids(R, arch, cfg, recsys_batch(arch, cfg, RECSYS_SERVE["serve_bulk"],
                                                            1, dev))
                bags = ids.reshape(-1, 1).to(torch.int32).contiguous()
                for t in big_tables(R, params):
                    run_case(f"recsys {arch} {list(t.shape)} {t.dtype}", t, bags, libs,
                             args.reps, cases)
                del params, ids, bags, t
                free_device_memory()
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
