"""Time the Sada-C listing kernel against other builds of it, and at other
block sizes, on one card at the main path's shape, and check them against
the plain version.

    python3 scripts/sada_c_ab.py [--other DIR ...] [--threads T ...]

Builds ``chip_smoke.py``'s phase 7 operands on the card (dna-p001 at scale
3.2: suffix data, the CSA at sample rate 16, the sparse-table RMQ over C),
plans the first batch of 32 patterns of phase 2 and masks its last four
rows as phase 7 does ((0, 0) twice, (0, n), (n - 1, n)), at ``max_df`` =
d + 1.  This tree's ``sada_c_list`` on a stored DA (Sada-C-D) and on the
CSA locate (Sada-C-L) is held to ``sada_c_list_plain`` bit for bit.
The slowest query's dependent reads are replayed on the host for both
designs (``chip_smoke.host_sada_c``, one thread a query, and
``host_sada_c_warp``) and printed with their latency bounds at the L1 and
L2 latencies the pointer-chase probe measures.  Beside it, each build of
``retrieval_kernels.cu`` (this tree's and ``--other`` checkouts', each
compiled by its own ``nvcc``) is called through
``rt_sada_c_list`` and ``rt_sada_c_list_csa`` at each block size of
``--threads`` (the launchers' last int: queries per block in the
one-thread-per-query kernel, warps per block in the warp-per-query one),
its rows held to this tree's, and all are timed in turns (the list, then
reversed) by CUDA events around calls queued behind a spin kernel.  Prints
the card's name and power limit, and one JSON line of results last.  Needs
one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from ab_build import bind, build_library, ptxas_line  # noqa: E402
from chip_smoke import (  # noqa: E402
    FULL_SCALE, HostLocate, host_sada_c, host_sada_c_warp, host_stored_da, load_latency_ns,
    longest, nvidia_smi_line, queued_time_ms, require,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import sada_c_list as sc  # noqa: E402
from repro_torch.kernels.csa_view import check_csa_operands  # noqa: E402

LAUNCHERS = ("rt_sada_c_list", "rt_sada_c_list_csa")


def list_with(lib, source, ops, lo, hi, d, max_df, threads):
    """One launch of ``lib``'s Sada-C launcher on ``source`` (the DA
    tensor or the CSA): (docs, cnt)."""
    values, table = ops
    B, dev = lo.shape[0], lo.device
    levels, n = table.shape
    docs = torch.empty((B, max_df), dtype=torch.int32, device=dev)
    cnt = torch.empty(B, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rmq = (table.data_ptr(), values.data_ptr())
    outs = (lo.data_ptr(), hi.data_ptr(), docs.data_ptr(), cnt.data_ptr())
    if isinstance(source, torch.Tensor):
        err = lib.rt_sada_c_list(*rmq, source.data_ptr(), *outs, B, levels, n, d, max_df,
                                 threads, stream)
    else:
        ptrs, ints = check_csa_operands(source, dev)
        err = lib.rt_sada_c_list_csa(*ptrs, *rmq, *outs, *ints, B, levels, d, max_df,
                                     threads, stream)
    _build.check(err, "sada_c_list")
    return docs, cnt


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", nargs="*", default=[], help="checkouts whose kernel to time beside")
    ap.add_argument("--threads", nargs="*", type=int, default=[],
                    help="block sizes to launch every build at")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sada_c_ab: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core.csa import build_csa, csa_search_planned
    from repro_torch.core.suffix import build_suffix_data
    from repro_torch.data.collections import (
        generate, pad_patterns, paperlike_collections, random_substring_patterns,
    )
    from repro_torch.succinct.rmq import rmq_build

    smi = nvidia_smi_line()
    print(f"[ab] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    this = bind(ctypes.CDLL(str(_build.build())), LAUNCHERS)
    print(ptxas_line("this", _build.build_log.get("ptxas", {}), "sada_c"), flush=True)
    coll = generate(paperlike_collections(scale=FULL_SCALE)["dna-p001"])
    data = build_suffix_data(coll, dev)
    csa = build_csa(data)
    rmq_c = rmq_build(data.c)
    pats = random_substring_patterns(coll, 2000, 6, 128, data=data)[:32]
    p, ln = pad_patterns(pats, 8)
    lo, hi = csa_search_planned(csa, torch.from_numpy(p).to(dev), torch.from_numpy(ln).to(dev))
    n, d = coll.n, coll.d
    lo = torch.cat([lo[:-4], torch.tensor([0, 0, 0, n - 1], dtype=torch.int32, device=dev)])
    hi = torch.cat([hi[:-4], torch.tensor([0, n, 0, n], dtype=torch.int32, device=dev)])
    max_df = d + 1
    ops = (rmq_c.values, rmq_c.table)
    sources = {"da": data.da, "csa": csa}
    result = {"device": smi, "n": n, "d": d, "B": int(lo.shape[0]), "max_df": max_df,
              "shared_bytes_per_warp": sc.shared_bytes_per_warp(d, max_df)}
    want = {}
    for name, src in sources.items():
        k = sc.sada_c_list(*ops, src, lo, hi, d=d, max_df=max_df)
        p = sc.sada_c_list_plain(*ops, src, lo, hi, d=d, max_df=max_df)
        mism = sum(int((x != y).sum()) for x, y in zip(k, p))
        print(f"[ab] {name}: mismatches against the plain version {mism}", flush=True)
        require(mism == 0, (name, "kernel != plain version"))
        want[name] = k
        result[f"{name}_pops_reported"] = int(k[1].sum())
    lat = load_latency_ns(dev)
    result["latency_ns"] = lat
    hlo, hhi = lo.cpu().numpy(), hi.cpu().numpy()
    vals_h, table_h = rmq_c.values.cpu().numpy(), rmq_c.table.cpu().numpy()
    locate, stored = HostLocate(csa), host_stored_da(data.da.cpu().numpy())
    for name, one, source in (("da", stored, data.da.cpu().numpy()), ("csa", locate, locate)):
        for design, replay, get in (("one_thread", host_sada_c, one),
                                    ("warp", host_sada_c_warp, source)):
            rows, cnt, pops, chains = replay(vals_h, table_h, get, hlo, hhi, d, max_df)
            require(np.array_equal(rows, want[name][0].cpu().numpy()), (name, design))
            ms, rounds = longest(chains, lat)
            result[f"{name}_{design}_chain"] = dict(rounds, latency_bound_ms=ms, pops=sum(pops))
            print(f"[ab] {name} {design} chain: {rounds} ({ms:.5f} ms), pops {sum(pops)}",
                  flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"this": this}
        libs.update({f"other{i}": build_library(os.path.join(o, "src", "repro_torch", "csrc"),
                                                tmp, f"other{i}", LAUNCHERS, "sada_c")
                     for i, o in enumerate(args.other)})
        runs = {(lib, t): libs[lib] for lib in libs for t in args.threads}
        for (label, t), lib in runs.items():
            for name, src in sources.items():
                got = list_with(lib, src, ops, lo, hi, d, max_df, t)
                mism = sum(int((x != y).sum()) for x, y in zip(got, want[name]))
                require(mism == 0, (label, t, name, "differs from this tree's wrapper"))
        fns = {("wrapper", 0, name): (lambda src=src: sc.sada_c_list(*ops, src, lo, hi, d=d,
                                                                    max_df=max_df))
               for name, src in sources.items()}
        fns.update({(label, t, name): (lambda lib=lib, t=t, src=src: list_with(
            lib, src, ops, lo, hi, d, max_df, t))
            for (label, t), lib in runs.items() for name, src in sources.items()})
        keys = list(fns)
        times = {}
        for key in keys + keys[::-1]:
            times.setdefault(key, []).append(queued_time_ms(fns[key], 20))
    result["device_ms"] = {f"{lab}/threads={t}/{name}": v for (lab, t, name), v in times.items()}
    for k, v in result["device_ms"].items():
        print(f"[ab] {k}: device ms {' '.join(f'{x:.5f}' for x in v)}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
