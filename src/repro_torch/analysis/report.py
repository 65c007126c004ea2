"""CLI driver: run both analysis layers, emit a JSON report, gate CI
(counterpart of ``repro.analysis.report``).

``python -m repro_torch.analysis`` runs

1. the **AST lint** (``repro_torch.analysis.lint``) over
   ``src/repro_torch``, and
2. the **contract audit** (``repro_torch.analysis.contracts``) over every
   (kind x power-of-two batch bucket) endpoint program of a small
   synthetic index, flat and as 4 document shards on the same device:
   the contracts are properties of the programs, not of the data, so a
   tiny collection proves them for every index that runs through the same
   builders.

The audit runs on the card unless ``--device cpu`` asks for the CPU (the
plain versions' route).  Exit status is nonzero iff any violation
survived the allowlist, so the command is a CI gate; ``--report`` writes
the machine-readable JSON (per program: launches, output dtypes and, on
the card, the captured graph's nodes).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

#: document shards of the audited sharded service
AUDIT_SHARDS = 4


def build_audit_services(device):
    """The reference's audit collection (``repro.analysis.report``) as a
    flat service and as ``AUDIT_SHARDS`` document shards, both on
    ``device``: big enough that every engine runs real work, small enough
    to audit in seconds."""
    from repro_torch.data.collections import SyntheticSpec, generate
    from repro_torch.dist.sharding import make_docs_mesh
    from repro_torch.serve.retrieval import RetrievalService

    coll = generate(SyntheticSpec(
        "version", n_base=2, n_variants=4, base_len=60, mutation_rate=0.01, seed=7,
    ))
    flat = RetrievalService.build(coll, validate=False, device=device)
    sharded = RetrievalService.build(coll, mesh=make_docs_mesh(AUDIT_SHARDS, device),
                                     validate=False, device=device)
    return flat, sharded


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="analysis gate: endpoint contract audit + AST lint",
    )
    ap.add_argument("--report", type=pathlib.Path, default=None,
                    help="write the JSON report here (CI artifact)")
    ap.add_argument("--root", type=pathlib.Path, default=None,
                    help="tree to lint (default: the repro_torch package itself)")
    ap.add_argument("--buckets", default="1,8",
                    help="comma-separated batch buckets to audit")
    ap.add_argument("--lint-only", action="store_true",
                    help="skip the contract audit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the audited programs run (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import lint as lint_mod

    root = args.root or pathlib.Path(__file__).resolve().parents[1]
    lint_violations, lint_stats = lint_mod.lint_tree(root)
    report = {
        "lint": {
            **lint_stats,
            "violations": [v.as_dict() for v in lint_violations],
        },
    }

    contract_violations = []
    audited = 0
    if not args.lint_only:
        from repro_torch.analysis.contracts import audit_service, audit_sharded_service
        from repro_torch.common import resolve_device

        buckets = tuple((int(b), 8) for b in args.buckets.split(",") if b.strip())
        flat, sharded = build_audit_services(resolve_device(args.device))
        report["contracts"], flat_violations = audit_service(flat, buckets=buckets)
        report["contracts_sharded"], sh_violations = audit_sharded_service(
            sharded, buckets=buckets)
        contract_violations = flat_violations + sh_violations
        audited = (report["contracts"]["contracts_audited"]
                   + report["contracts_sharded"]["contracts_audited"])

    n_bad = len(lint_violations) + len(contract_violations)
    report["ok"] = n_bad == 0

    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=2, sort_keys=True))

    for v in lint_violations:
        print(f"{v.location} {v.rule} [{v.qualname}] {v.message}\n"
              f"    fix: {v.fixit}", file=sys.stderr)
    for v in contract_violations:
        print(f"{v.contract} {v.check}: {v.message}", file=sys.stderr)
    if n_bad:
        print(f"repro_torch.analysis: {n_bad} violation(s)", file=sys.stderr)
        return 1
    print(f"repro_torch.analysis: clean ({lint_stats['files_scanned']} files linted, "
          f"{audited} endpoint contracts audited)")
    return 0
