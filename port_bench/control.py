"""The control of each cell: the reference put in the program's place with
one stated guarantee broken (``list``: rows in the order the suffixes are
met, not the smallest ids ascending; ``topk``: Brute-L's frequencies over
half its buffer) or computed in the precision below the stated one
(``tfidf``: bfloat16 weights and fold), answering the same requests a run
sends, and judged by the same comparison.  It has to come out not correct.

    python3 port_bench/control.py --workload <name> --seeds 1 2 3 --requests 40000

Prints one JSON line a seed with the numbers compared and their limits.
Needs no card: the control is NumPy."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from port_bench.harness.bench import load_cell, make_inputs, semantics
    from port_bench.reference.judge import compare, control_answers

    cell = load_cell(args.workload)
    sem = semantics(cell)
    for seed in args.seeds:
        t0 = time.perf_counter()
        _, ref, _, clients = make_inputs(cell, seed)
        reqs = [clients.draw() for _ in range(args.requests)]
        answers = control_answers([(k, key, p, None) for k, key, p in reqs], ref, sem)
        numbers, flags = compare(answers, ref, sem, cell.workload["limits"])
        print(json.dumps({"workload": cell.name, "seed": seed, "requests": len(reqs),
                          "wrong": sum(flags), "numbers": numbers,
                          "correct": all(v <= lim for v, lim in numbers.values()),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
