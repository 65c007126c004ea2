"""One run of one cell: the set-up, the warm-up, the measured window, the
reading of the trace, and the comparison with the reference.

Everything that belongs to one cell, configuration or per-layer metric is
found by name under ``<root>/port_bench`` (``workloads/<name>.json``,
``configs/<name>.json``, ``metrics/<name>.py``) and in
``<root>/BENCHMARK.json``, so a new cell needs new files and an entry, and
no edit here."""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path

import numpy as np

from port_bench.harness.trace import (
    ServiceProxy,
    Spans,
    busy_intervals,
    device_events,
    idle_gaps_by_host,
    is_kernel,
    top_device_ops,
)
from port_bench.reference.answers import Reference, Semantics
from port_bench.reference.collection import generate
from port_bench.reference.judge import compare
from port_bench.traffic.clients import Clients
from port_bench.traffic.patterns import pattern_pool

ROOT = Path(__file__).resolve().parents[2]

#: warm-up ends after this many batches in a row with no capture, and not
#: before this many batches
WARM_QUIET = 16
WARM_MIN = 32
WARM_MAX_S = 300.0
#: the latency a failed or wrong answer counts with
MISSED_S = 1e6
#: seconds a traced run profiles before its window (all of a shorter
#: ``--seconds``)
PROFILE_SECONDS = 2.0


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict        # the cell's entry in BENCHMARK.json
    workload: dict     # workloads/<name>.json
    config: dict       # configs/<config>.json
    end_to_end: list   # the BENCHMARK.json metrics this cell reports
    per_layer: list
    root: Path


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = json.loads((root / "port_bench" / "workloads" / f"{name}.json").read_text())
    if workload.get("config", entry["config"]) != entry["config"]:
        raise SystemExit(f"{name}: workload file names config {workload['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    config = json.loads((root / "port_bench" / "configs" / f"{entry['config']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name, entry, workload, config, mine(bench["end_to_end"]),
                mine(bench["per_layer"]), root)


def sub_seeds(seed: int, count: int) -> list[int]:
    """Independent seeds of the collection, the pool and the draws."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [int(s.generate_state(1, np.uint64)[0]) for s in ss.spawn(count)]


def allocated(torch, dev) -> int | None:
    """Bytes the card's allocator holds in live tensors, once every freed
    object is collected (None off the card, which keeps no such count)."""
    if dev.type != "cuda":
        return None
    gc.collect()
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def make_inputs(cell: Cell, seed: int):
    """The collection, its reference, the pattern pool and the clients'
    draws of one seed (the benchmark's own code; the program gets only the
    collection and the requests)."""
    wl, cfg = cell.workload, cell.config
    s_coll, s_draw, *s_pools = sub_seeds(seed, 2 + len(wl["pools"]))
    coll = generate(cfg["family"], cfg["n_base"], cfg["n_variants"], cfg["base_len"],
                    cfg["mutation_rate"], cfg["alphabet"], seed=s_coll)
    ref = Reference(coll.text, coll.doc_starts, coll.d)
    pools = {name: pattern_pool(ref, p["extracts"], p["length"], p["keep"], s, p["rank"])
             for (name, p), s in zip(sorted(wl["pools"].items()), s_pools)}
    return coll, ref, pools, Clients(wl, pools, s_draw)


def semantics(cell: Cell) -> Semantics:
    """The knobs that decide an answer, from the cell's own files."""
    rt = cell.workload["runtime"]
    return Semantics(max_df=rt["max_df"], max_buf=rt["max_buf"], k=rt["k"],
                     conjunctive=rt["tfidf_conjunctive"],
                     occ_df_threshold=cell.config["guarantees"]["occ_df_threshold"])


def _load_reader(root: Path, name: str):
    path = root / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Loop:
    """Closed-loop clients over the runtime: one loop submits and steps."""

    def __init__(self, rt, clients: Clients, spans: Spans | None = None):
        self.rt, self.clients, self.spans = rt, clients, spans
        self.inflight: dict[int, tuple] = {}

    def fill(self):
        if self.spans is None:
            return self._fill()
        with self.spans.span("clients"):
            self._fill()

    def _fill(self):
        while len(self.inflight) < self.clients.count:
            kind, key, payload = self.clients.draw()
            t = time.perf_counter()
            rid = self.rt.submit(kind, payload)
            self.inflight[rid] = (kind, key, payload, t)

    def drain(self, out: list):
        """Answer every request in flight, submitting none."""
        for a in self.rt.run_until_idle().values():
            out.append((*self.inflight.pop(a.rid), time.perf_counter(), a))

    def step(self, out: list | None):
        if self.spans is None:
            answers = self.rt.step()
        else:
            with self.spans.span("runtime.step"):
                answers = self.rt.step()
        t = time.perf_counter()
        for a in answers:
            req = self.inflight.pop(a.rid)
            if out is not None:
                out.append((*req, t, a))
        return len(answers)


def _program():
    """The program under test, imported only when a run starts."""
    import torch

    from repro_torch.core.suffix import Collection
    from repro_torch.serve.retrieval import RetrievalService
    from repro_torch.serve.runtime import RuntimeConfig, ServeRuntime

    return torch, Collection, RetrievalService, RuntimeConfig, ServeRuntime


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, log=print) -> tuple[dict, dict]:
    """One run: (the result line's object, the numbers compared with their
    limits).  ``device`` is the card in every benchmark run; the CPU only
    in the tests, which drive the same path at a tiny size."""
    enabled = gc.isenabled()
    try:
        return _run_cell(cell, seed, seconds, trace, device, t_start, log)
    finally:
        if enabled:
            gc.enable()


def _run_cell(cell, seed, seconds, trace, device, t_start, log):
    t_start = time.perf_counter() if t_start is None else t_start
    torch, PortCollection, RetrievalService, RuntimeConfig, ServeRuntime = _program()
    wl, cfg = cell.workload, cell.config
    coll, ref, pools, clients = make_inputs(cell, seed)

    # -- the program: build, runtime, warm-up ----------------------------------
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = allocated(torch, dev)
    svc = RetrievalService.build(
        PortCollection(text=coll.text, doc_starts=coll.doc_starts, doc_ends=coll.doc_ends,
                       d=coll.d, sigma=coll.sigma), device=dev, **cfg["index"])
    # what the built service keeps on the card; the program cache's graphs
    # and pools come later, in the warm-up
    index_bytes = None if before is None else allocated(torch, dev) - before
    rcfg = RuntimeConfig(**wl["runtime"])
    sem = semantics(cell)
    if svc.occ_df_threshold != sem.occ_df_threshold:
        raise SystemExit(f"the service dispatches at occ/df {svc.occ_df_threshold}, the "
                         f"configuration states {sem.occ_df_threshold}")
    spans = Spans(annotate=trace) if trace else None
    rt = ServeRuntime(ServiceProxy(svc, spans) if trace else svc, rcfg)
    loop = Loop(rt, clients)

    def captures():
        return sum(svc.compile_counts.values())

    # the window keeps every answer until the reference has judged it: a
    # cyclic collection over that heap would pause the loop at random
    gc.collect()
    gc.disable()
    t_warm = time.perf_counter()
    quiet, batches, last = 0, 0, captures()
    while (quiet < WARM_QUIET or batches < WARM_MIN) and \
            time.perf_counter() - t_warm < WARM_MAX_S:
        loop.fill()
        loop.step(None)
        batches += 1
        now = captures()
        quiet = quiet + 1 if now == last else 0
        last = now
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"[bench] {cell.name}: n={coll.n} d={coll.d}, pools "
        f"{ {k: len(v) for k, v in pools.items()} }, build "
        f"{sum(svc.build_seconds.values()):.2f} s, warm-up {batches} batches "
        f"{time.perf_counter() - t_warm:.2f} s, captures {dict(svc.compile_counts)}")

    # -- the traced run: a profiled stretch first, then the window ----------------
    profiled: list = []
    prof, prof_s, prof_batches = None, 0.0, 0
    loop.spans = spans
    if trace:
        from torch.profiler import ProfilerActivity, profile

        batches0 = rt.metrics.batches
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        t_p0 = time.perf_counter()
        while time.perf_counter() - t_p0 < min(PROFILE_SECONDS, seconds):
            loop.fill()
            loop.step(profiled)
        # nothing waits in the queue while the profiler stops (seconds)
        loop.drain(profiled)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof_s = time.perf_counter() - t_p0
        prof.stop()
        prof_batches = rt.metrics.batches - batches0
        spans.annotate = False  # the window's spans need no trace annotation

    # -- the measured window ----------------------------------------------------
    # (in a traced run its spans give the host's per-layer metrics, away
    # from the profiler's own cost)
    if trace:
        spans.records.clear()
    m0 = dataclasses.replace(rt.metrics)
    captures0 = captures()
    window: list = []
    t_begin = time.perf_counter()
    t_end = t_begin + seconds
    n_batches = 0
    marks = [t_begin]
    while True:
        loop.fill()
        loop.step(window)
        n_batches += 1
        marks.append(time.perf_counter())
        if marks[-1] >= t_end:
            break
    t_close = time.perf_counter()
    window_s = t_close - t_begin
    m1 = dataclasses.replace(rt.metrics)
    captures1 = captures()
    drained: list = []
    loop.spans = None
    loop.drain(drained)
    unanswered = len(loop.inflight)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    space = svc.space_report()
    build_seconds = dict(svc.build_seconds)
    n = coll.n
    gaps = np.diff(marks) * 1e3
    log(f"[bench] batch ms p10 {np.percentile(gaps, 10):.3f} p50 {np.percentile(gaps, 50):.3f} "
        f"p90 {np.percentile(gaps, 90):.3f} max {gaps.max():.3f}; batches each second "
        f"{np.bincount(((np.asarray(marks[1:]) - t_begin) // 1).astype(int)).tolist()}")
    log(f"[bench] window {window_s:.3f} s, {n_batches} batches, {len(window)} answers; "
        f"drained {len(drained)}, unanswered {unanswered}; captures in window "
        f"{captures1 - captures0}; peak {peak} B")

    # -- the trace --------------------------------------------------------------
    profile_view = None
    if trace:
        t0 = time.perf_counter()
        events, notes = device_events(prof)
        busy = busy_intervals(events)
        profile_view = {
            "events": events, "notes": notes, "window_s": prof_s,
            "busy_s": sum(e - s for s, e in busy) / 1e9, "batches": prof_batches,
            "kernels": sum(is_kernel(x[0]) for x in events),
            "breakdown": {"device_ops": top_device_ops(events),
                          "idle_gaps": idle_gaps_by_host(busy, notes)},
        }
        del prof
        log(f"[bench] trace: {len(events)} device events, busy "
            f"{profile_view['busy_s']:.4f} of {prof_s:.4f} s, {prof_batches} batches, "
            f"read in {time.perf_counter() - t0:.2f} s")

    # -- the program's state is freed before the reference runs -------------------
    del rt, loop, svc
    gc.enable()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------------------
    def judged(recs):
        full = [r for r in recs if r[5].path == "full" and not r[5].deadline_missed]
        return full, [(k, key, p, a.result) for k, key, p, _, _, a in full]

    t0 = time.perf_counter()
    full_w, ans_w = judged(window)
    _, ans_rest = judged(profiled + drained)
    numbers, wrong = compare(ans_w + ans_rest, ref, sem, wl["limits"])
    numbers["unanswered"] = [unanswered, 0]
    correct = all(v <= lim for v, lim in numbers.values())
    wrong_in_window = sum(wrong[: len(ans_w)])
    log(f"[bench] reference compared {len(ans_w) + len(ans_rest)} answers in "
        f"{time.perf_counter() - t0:.2f} s")

    failed = len(window) - len(full_w)
    attempted = len(window)
    ok = set(id(r) for r, bad in zip(full_w, wrong) if not bad)
    # a failed or wrong answer counts as missing any latency limit
    lat = np.asarray([(r[4] - r[3]) if id(r) in ok else MISSED_S for r in window])
    p95 = float(np.percentile(lat, 95)) if lat.size else MISSED_S
    e2e = {
        "queries_per_s": (len(full_w) - wrong_in_window) / window_s,
        "p95_ms": p95 * 1e3,
        "index_bits_per_char": None if index_bytes is None else index_bytes * 8 / n,
        "setup_s": t_begin - t_start,
    }

    if not trace:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if e2e[m["name"]] is not None}
    else:
        run = RunView(
            spans=spans.records, profile=profile_view, metrics_before=m0, metrics_after=m1,
            captures=captures1 - captures0, max_batch=rcfg.max_batch,
            build_seconds=build_seconds, space=space)
        metrics = {}
        for m in cell.per_layer:
            value = _load_reader(cell.root, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind_name,
              "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=profile_view["busy_s"], window_s=profile_view["window_s"])
        result["breakdown"] = profile_view["breakdown"]
    return result, numbers


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader sees of a traced run."""

    spans: list            # (name, start s, end s), host perf_counter
    profile: dict | None   # device events, annotations, busy, batches, kernels
    metrics_before: object  # RuntimeMetrics at the window's start and end
    metrics_after: object
    captures: int
    max_batch: int
    build_seconds: dict
    space: dict
