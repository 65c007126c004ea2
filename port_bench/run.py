"""Run one cell of the benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's collection, pattern pool and request draws come from ``--seed``;
the program under test (``repro_torch``, from ``src/``) builds its index on
the card, serves closed-loop clients through ``ServeRuntime`` for
``--seconds``, and every answer is compared with the NumPy reference in
``port_bench/reference``.  The last line of standard output is one JSON
object; the last lines of standard error name each number compared beside
its limit.  With ``--trace 0`` the metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones, read from a profiled window.

A run needs a CUDA card: without one it exits with code 2 and no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level modules that may not be loaded in the process that prints the
#: result (the JAX package's name is compared whole: ``repro_torch`` is
#: the program)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def compared_lines(numbers: dict) -> list[str]:
    return [f"{name} {value} limit {limit}" for name, (value, limit) in numbers.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from port_bench.harness.bench import load_cell, run_cell

    cell = load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one loop drives the card: few host threads keep its timing steady
    torch.set_num_threads(1)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    result, numbers = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                               t_start=T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"port_bench: the run loaded {', '.join(found)}; no result")
        return 3
    result["compared"] = {name: {"value": v, "limit": lim} for name, (v, lim) in numbers.items()}
    for line in compared_lines(numbers):
        log(line)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
