"""Retrieval serving on the PyTorch/CUDA port with batched requests behind
the resilient runtime.

Every batch executes as ONE program per (endpoint, shape bucket), a CUDA
graph on the card; the ``ServeRuntime`` in front adds per-request
deadlines, retry/breaker fault handling, and graceful degradation.  The
first execution of each (endpoint, bucket) builds (on the card: captures)
its program and is reported apart from the steady-state percentiles.

    PYTHONPATH=src python examples/torch_serve_retrieval.py [--requests 200]
        [--deadline-ms 500] [--inject executor_fail:0.1,slow_pdl]
        [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.data.collections import SyntheticSpec, generate, random_substring_patterns
from repro_torch.serve import faults
from repro_torch.serve.planner import ENGINE_BRUTE, ENGINE_PDL
from repro_torch.serve.retrieval import RetrievalService
from repro_torch.serve.runtime import RuntimeConfig, ServeRuntime


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--deadline-ms", type=float, default=500.0,
                    help="per-request deadline (see ServeRuntime)")
    ap.add_argument("--inject", default=None,
                    help="comma-separated fault specs, e.g. "
                         "'executor_fail:0.1,slow_pdl' (see repro_torch.serve.faults)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()

    coll = generate(
        SyntheticSpec("version", n_base=8, n_variants=16, base_len=400,
                      mutation_rate=0.01)
    )
    print(f"corpus: n={coll.n}, d={coll.d}")
    t0 = time.time()
    svc = RetrievalService.build(coll, block_size=32, beta=8.0, device=args.device)
    print(f"index build: {time.time() - t0:.1f}s "
          f"(BWT runs={svc.csa.bwt_runs}, ILCP runs={svc.ilcp.nruns}, "
          f"integrity fingerprints: {sorted(svc.fingerprints)})")

    workload = random_substring_patterns(coll, 800, 6, 64, device=args.device)
    if not workload:
        raise SystemExit("no patterns extracted")

    # the planner's engine mix for this workload (device-computed dispatch)
    plan = svc.plan(workload)
    n_brute = int((plan["engine"] == ENGINE_BRUTE).sum())
    n_pdl = int((plan["engine"] == ENGINE_PDL).sum())
    print(f"planner dispatch over {len(workload)} patterns: "
          f"{n_brute} brute / {n_pdl} pdl (occ/df threshold "
          f"{svc.occ_df_threshold})")

    rt = ServeRuntime(svc, RuntimeConfig(
        max_batch=args.batch, k=args.k,
        default_deadline_s=args.deadline_ms / 1e3,
    ))
    rt.warmup(kinds=("count", "topk"), batch_sizes=(args.batch,))
    # realistic warm waves settle the grow-only brute windows (each growth
    # builds the bucket's program again) so the timed loop is steady-state
    warm_rng = np.random.default_rng(1)
    for kind in ("count", "topk"):
        for _ in range(2):
            rt.serve([(kind, workload[i])
                      for i in warm_rng.integers(0, len(workload), args.batch)],
                     deadline_s=1e9)

    specs = faults.parse_fault_specs(args.inject) if args.inject else []
    served = 0
    lat = []
    rng = np.random.default_rng(0)
    with faults.inject(*specs):
        while served < args.requests:
            batch = [workload[i]
                     for i in rng.integers(0, len(workload), args.batch)]
            t0 = time.perf_counter()
            for p in batch:
                rt.submit("count", p)
                rt.submit("topk", p)
            answers = rt.run_until_idle()
            lat.append(time.perf_counter() - t0)
            served += len(batch)
    m = rt.metrics
    lat_ms = np.asarray(lat) * 1e3
    print(f"served {served} queries in batches of {args.batch}"
          + (f" with faults {args.inject}" if args.inject else ""))
    print(f"steady-state batch latency ms: p50={np.percentile(lat_ms, 50):.1f} "
          f"p99={np.percentile(lat_ms, 99):.1f} "
          f"throughput={2 * served / lat_ms.sum() * 1e3:.0f} q/s")
    print(f"program build cost per (endpoint, bucket), excluded from the above: "
          f"{m.as_dict()['compile_s']}")
    print(f"resilience: degraded_fraction={m.degraded_fraction:.3f} "
          f"deadline_miss_rate={m.deadline_miss_rate:.3f} "
          f"retries={m.retries} breaker_trips={m.breaker_trips}")
    print(f"programs by endpoint (one per shape bucket): "
          f"{dict(svc.compile_counts)}")
    sample = next(a for a in answers.values() if a.kind == "topk")
    print(f"example: top-{args.k}={sample.result[:3]}... "
          f"(degraded={sample.degraded})")

    # parity spot-check against the per-query reference path
    sample_pats = workload[:8]
    assert svc.topk(sample_pats, k=args.k) == svc.topk(
        sample_pats, k=args.k, engine="reference"
    ), "batched engine diverged from reference"
    print("parity spot-check vs engine='reference': OK")


if __name__ == "__main__":
    main()
