"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Device and build: the card's name and power limit, then the two CUDA
   kernels built from ``src/repro_torch/csrc`` with nvcc for sm_90a.
2. Full path: ``RetrievalService`` built on the card for dna-p001 at
   scale 3.2 (n = 1,024,320, d = 320); ``plan``, ``count`` and
   ``list_docs`` (engines auto, ilcp, brute, pdl) on batches of 32 patterns,
   held against a host oracle from the port's own document array, with the
   kernel launch counts each endpoint must make.
3. Large index, no PDL: suffix data, CSA, Sada and ILCP on the card for
   dna-p001 at scale 12.8 (n ~ 16.4M, d = 1,280); ``plan_queries`` and
   ``ilcp_list_docs_da_planned`` on 1,024 patterns in batches of 128.
4. Kernels against their plain PyTorch versions on the card, on the real
   index arrays of phases 2 and 3 and on edge inputs: outputs must be
   bit-identical.  Times with CUDA events after a warm-up.

Prints one JSON line of kernel records, then the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and the non-tensor-core
# 32-bit rate, taken here for the kernels' int32 ALU operations.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

MAX_DF = 256
MAX_BUF = 4096
FULL_SCALE = 3.2     # dna-p001 at n = 1,024,320, with PDL
LARGE_SCALE = 12.8   # dna-p001 at n ~ 16.4M, no PDL
LARGE_QUERIES = 1024


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_calls(fn, reps: int):
    """Run ``fn`` ``reps`` times under torch.profiler: per call, the wall
    milliseconds, the device milliseconds summed over every kernel (and
    copy), the device activities, and the device milliseconds by kernel
    name.  Reads the raw Kineto events (nanosecond durations) and skips
    the profiler's slow per-event Python post-processing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    by_name, launches = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6 / reps
            launches += 1
    return {"wall_ms": wall, "device_ms": sum(by_name.values()) if by_name else None,
            "kernels_per_call": launches / reps, "by_kernel_ms": by_name}


def device_ms_of(prof: dict, substr: str):
    """Device milliseconds per call of the kernels whose name holds
    ``substr``; None where the profiler saw no device time."""
    hits = [v for k, v in prof["by_kernel_ms"].items() if substr in k]
    return sum(hits) if hits else None


def require(ok, msg="check failed"):
    """A check that stays in force under ``python -O``."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def reset_counts(kernels):
    for k in kernels:
        k.launches = 0


# ---------------------------------------------------------------------------
# Host replays: independent oracles that also count the work each query needs
# ---------------------------------------------------------------------------


def host_backward_search(words, prefix, zcount, base, pats, lens, n, sigma):
    """Per-query backward search in numpy: (lo, hi, active symbol steps)."""
    words = words.view(np.uint32)
    levels = words.shape[0]

    def rank1(lvl, pos):
        w = pos >> 5
        mask = (1 << (pos & 31)) - 1
        return int(prefix[lvl, w]) + bin(int(words[lvl, w]) & mask).count("1")

    los, his, steps = [], [], 0
    for row, m in zip(pats, lens):
        lo, hi = 0, n
        for t in range(int(m)):
            if lo >= hi:
                break
            steps += 1
            c = int(row[int(m) - 1 - t])
            if c < 0 or c >= sigma:
                lo = hi = 0 if c < 0 else n
                break
            for lvl in range(levels):
                bit = (c >> (levels - 1 - lvl)) & 1
                r1p, r1q = rank1(lvl, lo), rank1(lvl, hi)
                lo = lo - r1p if bit == 0 else int(zcount[lvl]) + r1p
                hi = hi - r1q if bit == 0 else int(zcount[lvl]) + r1q
            lo += int(base[c])
            hi += int(base[c])
        los.append(lo)
        his.append(max(lo, hi))
    return np.asarray(los, np.int32), np.asarray(his, np.int32), steps


def host_ilcp_list(vilcp, table, run_starts, da, lo, hi, d, max_df):
    """The Fig-1 recursion per query in Python (the reference's trajectory):
    (docs rows in discovery order, counts, pops, DA positions scanned)."""
    levels, rho = table.shape
    cap, max_pops = max_df + 4, 2 * max_df + 8
    starts = run_starts[:-1]
    rows, cnts, pops_total, scanned = [], [], 0, 0
    for a0, b0 in zip(lo.tolist(), hi.tolist()):
        stack = [(int(np.searchsorted(starts, a0, "right")) - 1,
                  int(np.searchsorted(starts, b0 - 1, "right")) - 1)]
        seen, out, pops = set(), [], 0
        while stack and len(out) < max_df and pops < max_pops:
            a, b = stack.pop()
            pops += 1
            if a > b or a0 >= b0:
                continue
            a, b = min(max(a, 0), rho - 1), min(max(b, 0), rho - 1)
            k = min(max(int(np.floor(np.log2(max(b - a + 1, 1)))), 0), levels - 1)
            ia, ib = int(table[k, a]), int(table[k, max(b - (1 << k) + 1, a)])
            r = ib if (vilcp[ib] < vilcp[ia] or (vilcp[ib] == vilcp[ia] and ib < ia)) else ia
            i, j = max(a0, int(run_starts[r])), min(b0, int(run_starts[r + 1]))
            aborted = False
            while i < j and len(out) < max_df:
                g = int(da[i])
                scanned += 1
                i += 1
                if g in seen:
                    aborted = True
                    break
                seen.add(g)
                out.append(g)
            if aborted:
                continue
            if r + 1 <= b and len(stack) < cap:
                stack.append((r + 1, b))
            if a <= r - 1 and len(stack) < cap:
                stack.append((a, r - 1))
        pops_total += pops
        cnts.append(len(out))
        rows.append(out + [-1] * (max_df - len(out)))
    return (np.asarray(rows, np.int32).reshape(len(cnts), max_df),
            np.asarray(cnts, np.int32), pops_total, scanned)


def check_listing(docs, cnt, lo, hi, da, max_df, max_buf=None, sorted_rows=True):
    """Rows ascending (or distinct, for discovery order), -1 padded, a subset
    of DA[lo:hi]'s documents, and all of them when df <= max_df and occ is
    within the row's buffer.  ``max_buf``: None (no engine buffer bounds the
    rows) or, per row, the bound of the engine that ran it (None for ILCP)."""
    for r in range(len(cnt)):
        truth = set(da[lo[r]:hi[r]].tolist())
        row = docs[r, : cnt[r]].tolist()
        require(np.all(docs[r, cnt[r]:] == -1), (r, "padding"))
        if sorted_rows:
            require(row == sorted(set(row)), (r, "not ascending and distinct"))
        else:
            require(len(set(row)) == len(row), (r, "duplicate documents"))
        require(set(row) <= truth, (r, "document outside DA[lo:hi]"))
        buf = None if max_buf is None else max_buf[r]
        if len(truth) <= max_df and (buf is None or hi[r] - lo[r] <= buf):
            require(set(row) == truth, (r, "incomplete listing"))


def engine_buffers(codes, max_buf):
    """Per-row listing buffer: Brute-L's window and PDL's candidate buffer
    are bounded by ``max_buf``; the ILCP recursion reads no buffer."""
    from repro_torch.serve.planner import ENGINE_BRUTE, ENGINE_PDL

    return [max_buf if c in (ENGINE_BRUTE, ENGINE_PDL) else None for c in codes]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    log(f"[build] {path.name} in {seconds:.2f} s")
    for line in _build.build_log.get("output", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("[ptxas]", line.strip())


def phase_full_path(dev, bs, il):
    from repro_torch.core.suffix import build_suffix_data
    from repro_torch.data.collections import (
        generate, paperlike_collections, random_substring_patterns,
    )
    from repro_torch.serve.planner import ENGINE_CODES
    from repro_torch.serve.retrieval import RetrievalService

    coll = generate(paperlike_collections(scale=FULL_SCALE)["dna-p001"])
    log(f"[full] dna-p001 x{FULL_SCALE}: n={coll.n} d={coll.d} sigma={coll.sigma}")
    t0 = time.perf_counter()
    svc = RetrievalService.build(coll, block_size=64, beta=16.0, device=dev)
    build_s = time.perf_counter() - t0
    log(f"[full] service build {build_s:.2f} s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in svc.build_seconds.items()))
    t0 = time.perf_counter()
    data = build_suffix_data(coll, dev)
    pats = random_substring_patterns(coll, 2000, 6, 128, data=data)
    log(f"[full] {len(pats)} patterns in {time.perf_counter() - t0:.2f} s")
    require(len(pats) >= 32, "workload generation produced too few patterns")
    require(torch.equal(svc.da, data.da))
    da = data.da.cpu().numpy()
    max_df = min(MAX_DF, coll.d + 1)

    kernels = (bs, il)
    batches = [pats[i:i + 32] for i in range(0, len(pats), 32)]
    lat = {}
    ilcp_nonempty = 0
    reset_counts(kernels)  # the main path's run starts here
    for batch in batches:
        def call(name, fn, *a, **kw):
            before = (bs.launches, il.launches)
            t = time.perf_counter()
            out = fn(*a, **kw)
            lat.setdefault(name, []).append(time.perf_counter() - t)
            return out, (bs.launches - before[0], il.launches - before[1])

        plan, delta = call("plan", svc.plan, batch)
        require(delta == (1, 0), ("plan launches", delta))
        lo, hi = plan["lo"], plan["hi"]
        truth_df = np.asarray([len(set(da[a:b].tolist())) for a, b in zip(lo, hi)])
        require(np.all(hi - lo == plan["occ"]) and np.all(plan["occ"] > 0))
        require(np.array_equal(plan["df"], truth_df), "plan df != distinct docs of DA[lo:hi]")
        cnt, delta = call("count", svc.count, batch)
        require(delta == (1, 0), ("count launches", delta))
        require(np.array_equal(cnt, truth_df), "count != distinct docs of DA[lo:hi]")
        for engine in ("auto", "ilcp", "brute", "pdl"):
            (docs, c), delta = call(f"list_docs[{engine}]", svc.list_docs_arrays, batch,
                                    max_df=max_df, engine=engine, max_buf=MAX_BUF)
            require(delta == (2, 1), (engine, "list launches", delta))
            require(docs.shape == (len(batch), max_df) and docs.dtype == np.int32)
            codes = plan["engine"] if engine == "auto" else [ENGINE_CODES[engine]] * len(c)
            check_listing(docs, c, lo, hi, da, max_df, engine_buffers(codes, MAX_BUF))
            if engine == "ilcp":
                ilcp_nonempty += int((c > 0).sum())
        svc.brute_window = MAX_BUF
        (docs, c), delta = call("list_docs[auto,pinned]", svc.list_docs_arrays, batch,
                                max_df=max_df, engine="auto", max_buf=MAX_BUF)
        svc.brute_window = None
        require(delta == (1, 1), ("pinned list launches", delta))
        check_listing(docs, c, lo, hi, da, max_df, engine_buffers(plan["engine"], MAX_BUF))
        lists = svc.list_docs(batch, max_df=max_df)
        require([len(x) for x in lists] == c.tolist())
    launches = {"backward_search": bs.launches, "ilcp_list": il.launches}
    require(launches["backward_search"] > 0 and launches["ilcp_list"] > 0, launches)
    require(ilcp_nonempty > 0, "ilcp_list returned no documents under engine='ilcp'")
    log(f"[full] {len(batches)} batches of 32, launches {launches}")
    log("[full] host seconds per batch: "
        + "; ".join(f"{k} " + " ".join(f"{x:.4f}" for x in v) for k, v in lat.items()))

    # where a batch's time goes: device busy time against the host clock,
    # for the last batch under the automatic engine choice
    prof = profile_calls(lambda: svc.list_docs_arrays(
        batches[-1], max_df=max_df, engine="auto", max_buf=MAX_BUF), 1)
    top = sorted(prof.pop("by_kernel_ms").items(), key=lambda kv: -kv[1])[:5]
    prof["top_kernels_ms"] = top
    engines = svc.plan(batches[-1])["engine"]
    prof["engines"] = {name: int((engines == code).sum())
                       for name, code in (("brute", 1), ("ilcp", 2), ("pdl", 3))}
    log(f"[full] list_docs[auto] profile, last batch {prof['engines']}: wall "
        f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']} ms, "
        f"{prof['kernels_per_call']:.0f} device activities; top "
        + "; ".join(f"{k[:40]} {v:.3f}" for k, v in top))
    log(f"[full] space report {svc.space_report()}")
    return svc, batches, launches


def phase_large(dev, bs, il):
    from repro_torch.core.csa import build_csa
    from repro_torch.core.ilcp import build_ilcp, ilcp_list_docs_da_planned
    from repro_torch.core.sada import build_sada
    from repro_torch.core.suffix import build_suffix_data
    from repro_torch.data.collections import (
        generate, paperlike_collections, random_substring_patterns, pad_patterns,
    )
    from repro_torch.serve.planner import plan_queries

    coll = generate(paperlike_collections(scale=LARGE_SCALE)["dna-p001"])
    log(f"[large] dna-p001 x{LARGE_SCALE}: n={coll.n} d={coll.d}")
    stages = {}
    t = time.perf_counter()
    data = build_suffix_data(coll, dev)
    torch.cuda.synchronize()
    stages["suffix"] = time.perf_counter() - t
    t = time.perf_counter()
    csa = build_csa(data)
    torch.cuda.synchronize()
    stages["csa"] = time.perf_counter() - t
    t = time.perf_counter()
    sada = build_sada(data)
    torch.cuda.synchronize()
    stages["sada"] = time.perf_counter() - t
    t = time.perf_counter()
    ilcp = build_ilcp(data)
    torch.cuda.synchronize()
    stages["ilcp"] = time.perf_counter() - t
    log("[large] build " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    pats = random_substring_patterns(coll, 4000, 6, LARGE_QUERIES, data=data)
    require(len(pats) == LARGE_QUERIES, len(pats))
    da = data.da.cpu().numpy()
    batches = []
    for i in range(0, len(pats), 128):
        p, ln = pad_patterns(pats[i:i + 128], 8)
        batches.append((torch.from_numpy(p).to(dev), torch.from_numpy(ln).to(dev)))
    reset_counts((bs, il))
    t = time.perf_counter()
    results = []
    for p, ln in batches:
        plan = plan_queries(csa, sada, p, ln, 4.0, -1)
        docs, cnt = ilcp_list_docs_da_planned(ilcp, data.da, plan.lo, plan.hi, MAX_DF)
        results.append((plan, docs, cnt))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = {"backward_search": bs.launches, "ilcp_list": il.launches}
    require(launches == {"backward_search": len(batches), "ilcp_list": len(batches)}, launches)
    for plan, docs, cnt in results:
        lo, hi = plan.lo.cpu().numpy(), plan.hi.cpu().numpy()
        df = plan.df.cpu().numpy()
        truth = np.asarray([len(set(da[a:b].tolist())) for a, b in zip(lo, hi)])
        require(np.array_equal(df, truth), "large: df != distinct docs of DA[lo:hi]")
        docs, cnt = docs.cpu().numpy(), cnt.cpu().numpy()
        check_listing(docs, cnt, lo, hi, da, MAX_DF, sorted_rows=False)
        require(np.all(cnt == np.minimum(truth, MAX_DF)), "large: truncated count")
    log(f"[large] {len(pats)} patterns in {len(batches)} batches: {run_s:.3f} s, "
        f"launches {launches}")
    large = {"csa": csa, "ilcp": ilcp, "da": data.da, "batches": batches,
             "ranges": [(plan.lo, plan.hi) for plan, _, _ in results]}
    log(f"[large] ILCP runs rho={ilcp.nruns}")
    return large


def kernel_checks(svc, full_batches, large):
    """Phase 4: each kernel against its plain version, bit for bit."""
    from repro_torch.core.csa import search_base
    from repro_torch.kernels.backward_search import (
        backward_search, backward_search_plain, reverse_patterns,
    )
    from repro_torch.kernels.ilcp_list import ilcp_list, ilcp_list_plain, runs_of

    def bws_case(csa, pats, lens):
        wm = csa.wm
        args = (wm.words, wm.ones_prefix, wm.zcount, search_base(csa))
        kw = dict(n=csa.n, sigma=csa.sigma)
        k = backward_search(*args, pats, lens, **kw)
        p = backward_search_plain(*args, reverse_patterns(pats, lens), lens, **kw)
        return k, p, (lambda: backward_search(*args, pats, lens, **kw)), \
            (lambda: backward_search_plain(*args, reverse_patterns(pats, lens), lens, **kw))

    def il_case(index, da, lo, hi, max_df):
        a = (index.vilcp, index.rmq.table, index.run_starts, da)
        kw = dict(d=index.d, max_df=max_df)
        k = ilcp_list(*a, lo, hi, **kw)
        lr, hr = runs_of(index.run_starts, lo), runs_of(index.run_starts, hi - 1)
        p = ilcp_list_plain(*a, lo, hi, lr, hr, **kw)
        return k, p, (lambda: ilcp_list(*a, lo, hi, **kw)), \
            (lambda: ilcp_list_plain(*a, lo, hi, lr, hr, **kw))

    def mismatches(k, p):
        return sum(int((x != y).sum()) for x, y in zip(k, p))

    def max_err(k, p):
        return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
                   for x, y in zip(k, p))

    dev = svc.da.device
    gen = torch.Generator().manual_seed(0)
    total = {"backward_search": 0, "ilcp_list": 0}
    errs = {"backward_search": 0, "ilcp_list": 0}

    def tally(name, k, p, label):
        mm = mismatches(k, p)
        total[name] += mm
        errs[name] = max(errs[name], max_err(k, p))
        log(f"[kernels] {name} {label}: mismatches {mm}")

    # -- backward search: main-path batches of both phases and edge rows
    from repro_torch.data.collections import pad_patterns
    main_pats = []
    for batch in full_batches:
        p, ln = pad_patterns(batch, 8)
        main_pats.append((torch.from_numpy(p).to(dev), torch.from_numpy(ln).to(dev)))
    for i, (p, ln) in enumerate(main_pats):
        k, pl, _, _ = bws_case(svc.csa, p, ln)
        tally("backward_search", k, pl, f"full batch {i}")
    for i, (p, ln) in enumerate(large["batches"]):
        k, pl, _, _ = bws_case(large["csa"], p, ln)
        tally("backward_search", k, pl, f"large batch {i}")
    sigma = svc.csa.sigma
    edge = torch.randint(0, sigma, (33, 9), generator=gen, dtype=torch.int32)
    edge_len = torch.randint(0, 10, (33,), generator=gen, dtype=torch.int32)
    edge[::4, 2] = -1
    edge[1::4, 0] = sigma
    edge_len[::5] = 0
    k, pl, _, _ = bws_case(svc.csa, edge.to(dev), edge_len.to(dev))
    tally("backward_search", k, pl, "edge rows (B=33, len 0, symbols -1 and sigma)")

    # -- ILCP listing: ranges of the main path, truncation, empty/padded rows
    full_ranges = []
    for p, ln in main_pats:
        lo, hi = backward_search(svc.csa.wm.words, svc.csa.wm.ones_prefix, svc.csa.wm.zcount,
                                 search_base(svc.csa), p, ln, n=svc.csa.n, sigma=sigma)
        full_ranges.append((lo, torch.where(ln > 0, hi, lo)))
    n = svc.csa.n
    for i, (lo, hi) in enumerate(full_ranges):
        k, pl, _, _ = il_case(svc.ilcp, svc.da, lo, hi, MAX_DF)
        tally("ilcp_list", k, pl, f"full batch {i}")
    lo0, hi0 = full_ranges[0]
    elo = torch.cat([lo0[:29], torch.tensor([0, 5, 7, 0], dtype=torch.int32, device=dev)])
    ehi = torch.cat([hi0[:29], torch.tensor([0, 5, 3, n], dtype=torch.int32, device=dev)])
    for max_df in (1, 2, 8):
        k, pl, _, _ = il_case(svc.ilcp, svc.da, elo, ehi, max_df)
        tally("ilcp_list", k, pl, f"edge ranges (B=33, max_df={max_df})")
    for i, (plan_lo, plan_hi) in enumerate(large["ranges"]):
        k, pl, _, _ = il_case(large["ilcp"], large["da"], plan_lo, plan_hi, MAX_DF)
        tally("ilcp_list", k, pl, f"large batch {i}")
        if i == 1:
            break  # two large batches are enough for the plain version's pace
    require(total == {"backward_search": 0, "ilcp_list": 0}, total)

    # -- times at the main-path shapes, bounds from this run's work
    records = []
    words = svc.csa.wm.words.cpu().numpy()
    prefix = svc.csa.wm.ones_prefix.cpu().numpy()
    zcount = svc.csa.wm.zcount.cpu().numpy()
    base = search_base(svc.csa).cpu().numpy()
    p, ln = main_pats[0]
    _, _, fk, fp = bws_case(svc.csa, p, ln)
    kms, pms = cuda_time_ms(fk, 50), cuda_time_ms(fp, 10)
    kdev = device_ms_of(profile_calls(fk, 20), "backward_search_kernel")
    hlo, hhi, steps = host_backward_search(words, prefix, zcount, base, p.cpu().numpy(),
                                           ln.cpu().numpy(), n, sigma)
    klo, khi = fk()
    require(np.array_equal(hlo, klo.cpu().numpy()) and np.array_equal(hhi, khi.cpu().numpy()))
    levels = words.shape[0]
    B, max_m = p.shape
    bw_bytes = steps * levels * 2 * 8 + steps * 4 + B * max_m * 4 + B * 4 + 2 * B * 4
    bw_ops = steps * levels * 2 * 10
    records.append(dict(
        name="backward_search", route="cuda", source="src/repro_torch/csrc/retrieval_kernels.cu",
        replaces="src/repro/kernels/backward_search.py:92",
        launches=None, max_abs_err=errs["backward_search"], mismatches=total["backward_search"],
        ms=kms, kernel_ms=kms, device_ms=kdev, plain_ms=pms, library_ms=None,
        bound_ms=max(bw_bytes / HBM_BYTES_PER_S, bw_ops / ALU_OPS_PER_S) * 1e3,
        bound_by="bytes" if bw_bytes / HBM_BYTES_PER_S >= bw_ops / ALU_OPS_PER_S else "operations",
        shape=f"B={B} max_m={max_m} levels={levels} n={n} active_steps={steps}",
    ))

    lo, hi = full_ranges[0]
    # the main path hands the kernel the ILCP-assigned ranges; with engine="ilcp"
    # that is every row
    _, _, fk, fp = il_case(svc.ilcp, svc.da, lo, hi, MAX_DF)
    kms, pms = cuda_time_ms(fk, 20), cuda_time_ms(fp, 2)
    kdev = device_ms_of(profile_calls(fk, 20), "ilcp_list_kernel")
    idx = svc.ilcp
    hd, hc, pops, scanned = host_ilcp_list(
        idx.vilcp.cpu().numpy(), idx.rmq.table.cpu().numpy(), idx.run_starts.cpu().numpy(),
        svc.da.cpu().numpy(), lo.cpu().numpy(), hi.cpu().numpy(), idx.d, MAX_DF)
    kd, kc = fk()
    require(np.array_equal(hd, kd.cpu().numpy()) and np.array_equal(hc, kc.cpu().numpy()),
            "ilcp_list kernel != host replay of the recursion")
    B = lo.shape[0]
    il_bytes = pops * 24 + scanned * 4 + B * 16 + B * (MAX_DF + 1) * 4
    il_ops = pops * 30 + scanned * 8
    records.append(dict(
        name="ilcp_list", route="cuda", source="src/repro_torch/csrc/retrieval_kernels.cu",
        replaces="src/repro/kernels/ilcp_list.py:193",
        launches=None, max_abs_err=errs["ilcp_list"], mismatches=total["ilcp_list"],
        ms=kms, kernel_ms=kms, device_ms=kdev, plain_ms=pms, library_ms=None,
        bound_ms=max(il_bytes / HBM_BYTES_PER_S, il_ops / ALU_OPS_PER_S) * 1e3,
        bound_by="bytes" if il_bytes / HBM_BYTES_PER_S >= il_ops / ALU_OPS_PER_S else "operations",
        shape=f"B={B} max_df={MAX_DF} d={idx.d} rho={idx.nruns} pops={pops} scanned={scanned}",
    ))

    # the large index: one batch of 128 for each kernel
    p, ln = large["batches"][0]
    _, _, fk, fp = bws_case(large["csa"], p, ln)
    records[0]["large_ms"] = cuda_time_ms(fk, 50)
    records[0]["large_device_ms"] = device_ms_of(profile_calls(fk, 20), "backward_search_kernel")
    records[0]["large_plain_ms"] = cuda_time_ms(fp, 10)
    lo, hi = large["ranges"][0]
    _, _, fk, fp = il_case(large["ilcp"], large["da"], lo, hi, MAX_DF)
    records[1]["large_ms"] = cuda_time_ms(fk, 20)
    records[1]["large_device_ms"] = device_ms_of(profile_calls(fk, 20), "ilcp_list_kernel")
    records[1]["large_plain_ms"] = cuda_time_ms(fp, 2)
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.backward_search import backward_search
    from repro_torch.kernels.ilcp_list import ilcp_list

    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    phase_build()
    t0 = time.perf_counter()
    svc, full_batches, main_launches = phase_full_path(dev, backward_search, ilcp_list)
    log(f"[full] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    large = phase_large(dev, backward_search, ilcp_list)
    log(f"[large] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records = kernel_checks(svc, full_batches, large)
    log(f"[kernels] phase {time.perf_counter() - t0:.1f} s")
    for r in records:
        r["launches"] = main_launches[r["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
