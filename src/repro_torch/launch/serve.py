"""Retrieval serving launcher (counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve [--corpus version-p001]
        [--queries 256] [--batch 32] [--k 10] [--mode topk|list|count|tfidf]
        [--deadline-ms 500] [--inject executor_fail:0.1,slow_pdl]
        [--device cuda]

Builds the index stack over a synthetic corpus (``paperlike_collections()``
at scale 1; the build validates it) on ``--device`` and serves batched
queries through the resilient runtime (``repro_torch.serve.runtime``:
deadlines, retry and breaker, graceful degradation).  The flags, defaults
and output lines are the reference's, plus ``--device`` (the card unless
``cpu`` is asked for).

Latency accounting is split: the first execution of each (endpoint,
shape bucket) builds (on the card: captures) its program and is reported
on its own line; the percentiles cover steady-state batches only.  Last,
the tracer's table (``repro_torch.serve.trace``) of the timed batches:
per span, device span or counter its records, milliseconds and self
milliseconds a batch (a counter: its value a batch).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.data.collections import (
    generate,
    paperlike_collections,
    random_substring_patterns,
)
from repro_torch.serve import faults
from repro_torch.serve.retrieval import RetrievalService
from repro_torch.serve.runtime import RuntimeConfig, ServeRuntime
from repro_torch.serve.trace import tracer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="version-p001",
                    choices=list(paperlike_collections()))
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--mode", default="topk",
                    choices=["topk", "list", "count", "tfidf"])
    ap.add_argument("--deadline-ms", type=float, default=500.0,
                    help="per-request deadline enforced by the runtime")
    ap.add_argument("--inject", default=None,
                    help="fault specs, e.g. 'executor_fail:0.1,slow_pdl' "
                         "(see repro_torch.serve.faults.NAMED_FAULTS)")
    ap.add_argument("--device", default="cuda",
                    help="device of the index and the queries (cuda or cpu)")
    args = ap.parse_args(argv)

    spec = paperlike_collections()[args.corpus]
    coll = generate(spec)
    t0 = time.time()
    svc = RetrievalService.build(coll, block_size=64, beta=16.0, device=args.device)
    print(f"corpus {args.corpus}: n={coll.n} d={coll.d}; "
          f"index built in {time.time()-t0:.1f}s (integrity validated: "
          f"{', '.join(sorted(svc.fingerprints))})")
    for k, v in svc.space_report().items():
        print(f"  {k:22s} {v if isinstance(v, int) else round(v, 3)}")

    workload = random_substring_patterns(coll, 2000, 6, 128, device=args.device)
    rng = np.random.default_rng(0)
    rt = ServeRuntime(svc, RuntimeConfig(
        max_batch=args.batch, k=args.k,
        max_df=min(256, coll.d + 1),
        default_deadline_s=args.deadline_ms / 1e3,
    ))

    def payload(i: int):
        if args.mode == "tfidf":
            j = rng.integers(0, len(workload))
            return [workload[i], workload[int(j)]]
        return workload[i]

    # warm pass: builds the (mode, bucket) program and settles the
    # grow-only brute windows outside the timed (and deadlined) loop
    for _ in range(2):
        rt.serve([(args.mode, payload(int(i)))
                  for i in rng.integers(0, len(workload), args.batch)],
                 deadline_s=1e9)

    specs = faults.parse_fault_specs(args.inject) if args.inject else []
    tracer.reset()
    lat = []
    served = 0
    with faults.inject(*specs):
        while served < args.queries:
            idx = rng.integers(0, len(workload), args.batch)
            t0 = time.perf_counter()
            rt.serve([(args.mode, payload(int(i))) for i in idx])
            lat.append(time.perf_counter() - t0)
            served += len(idx)
    m = rt.metrics
    ms = np.asarray(lat) * 1e3
    compiles = ", ".join(f"{k}={v}s" for k, v in m.as_dict()["compile_s"].items())
    print(f"compile (first batch per bucket, excluded below): {compiles}")
    print(f"{args.mode}: {served} queries, batch={args.batch}: "
          f"steady p50={np.percentile(ms,50):.1f}ms "
          f"p99={np.percentile(ms,99):.1f}ms ({served/ms.sum()*1e3:.0f} q/s)")
    print(f"resilience: degraded_fraction={m.degraded_fraction:.3f} "
          f"deadline_miss_rate={m.deadline_miss_rate:.3f} "
          f"retries={m.retries} breaker_trips={m.breaker_trips} "
          f"reasons={dict(m.degrade_reasons)}")
    for line in tracer.table():
        print(line)


if __name__ == "__main__":
    main()
