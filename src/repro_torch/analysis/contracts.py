"""Declarative endpoint contracts and the auditor that holds each endpoint
program to them (counterpart of ``repro.analysis.contracts``).

Every endpoint program (kind x power-of-two batch bucket) carries
invariants that no answer check sees:

* **launches**: the wrapper calls of one run per kernel.  ``plan`` calls
  the backward search once; ``list`` the backward search, the ILCP listing
  and the PDL gather once each; ``topk`` and ``tfidf`` (all Q x T terms)
  the backward search and the PDL gather once each; no endpoint calls
  ``rank`` or ``rmq``.  The docs-sharded service calls each S times, once
  per shard.  A second launch (a second wavelet descent is a second
  backward search) or a lost one is a silent regression.  The port's
  calls of the TPU kernels' counterparts (backward search + ILCP listing)
  equal the reference's ``pallas_calls`` on its kernel backend; the PDL
  gather is the port's own kernel (the reference gathers in XLA).
* **graph_kernels** (CUDA only): the captured graph's kernel nodes per
  kernel equal the recorded calls, so no kernel runs that no wrapper
  counted and no counted launch is missing from what replays.  Nodes of
  kernels outside the port are reported, not gated.
* **collective**: no NCCL kernel node.  The sharded service runs its
  shards on one card and has no process group.
* **host_sync** (CUDA only): the warm-up runs under
  ``set_sync_debug_mode("error")`` and the capture refuses a sync; on the
  CPU the lint's TR001 covers it statically.
* **wide_dtype**: no int64 or float64 program output and no such tensor
  into a kernel wrapper (the serving ABI is int32 indexes and float32
  scores).  torch's own index operations (``gather``, ``sort``,
  ``topk``) make int64 intermediates by design, so the check reads the
  program's boundary and its kernels' operands, not every intermediate as
  the reference reads every aval.

The reference's gather ceiling, VMEM budget and ``xla`` /
``kernel_overbudget`` backends have no counterpart: the descent is one
kernel, and the port has no VMEM budget and no fallback on CUDA tensors.
Its only other route, the plain versions on CPU tensors, is audited with
the same counts under ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis.programs import WRAPPERS, kernel_of

#: the wrappers an endpoint program may call, and the kernels it must not
ENDPOINT_KERNELS = ("backward_search", "ilcp_list", "pdl_gather", "rank", "rmq")
WIDE_DTYPES = ("int64", "uint64", "float64", "complex128")

#: wrapper calls per program of one flat service, per kind
_PER_KIND = {
    "plan": {"backward_search": 1},
    "list": {"backward_search": 1, "ilcp_list": 1, "pdl_gather": 1},
    "topk": {"backward_search": 1, "pdl_gather": 1},
    "tfidf": {"backward_search": 1, "pdl_gather": 1},
}


@dataclasses.dataclass(frozen=True)
class EndpointContract:
    """One audited (kind x bucket x device) endpoint program."""

    kind: str                 # "plan" | "list" | "topk" | "tfidf"
    bucket: tuple             # (batch_bucket, len_bucket)
    device: str               # "cuda" | "cpu"
    launches: dict            # wrapper name -> calls of one run (0 = none)
    #: NCCL kernels the graph may hold; () = none (every program here)
    collectives_allowed: tuple = ()
    #: report grouping ("" = one index, "docs" = the docs-sharded service)
    mesh_axis: str = ""

    @property
    def key(self) -> str:
        pre = f"{self.mesh_axis}:" if self.mesh_axis else ""
        return f"{pre}{self.kind}/B{self.bucket[0]}xm{self.bucket[1]}/{self.device}"


@dataclasses.dataclass(frozen=True)
class Violation:
    contract: str             # EndpointContract.key
    check: str                # "launches" | "graph_kernels" | "collective"
    message: str              #   | "host_sync" | "wide_dtype"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _kinds(svc) -> tuple:
    """The kinds a service can run: ``topk`` and ``tfidf`` need the top-k
    PDL (every shard's, for the sharded service)."""
    shards = getattr(svc, "shards", [svc])
    has_topk = all(sh.pdl_topk is not None for sh in shards)
    return svc.ENDPOINT_KINDS if has_topk else ("plan", "list")


def _contracts(svc, buckets, shards: int, mesh_axis: str) -> list[EndpointContract]:
    out = []
    for bucket in buckets:
        for kind in _kinds(svc):
            launches = {k: shards * _PER_KIND[kind].get(k, 0) for k in ENDPOINT_KERNELS}
            out.append(EndpointContract(kind, tuple(bucket), svc.device.type, launches,
                                        mesh_axis=mesh_axis))
    return out


def build_registry(svc, buckets=((1, 8), (8, 8))) -> list[EndpointContract]:
    """Contracts for every endpoint program of a flat ``RetrievalService``
    on its device."""
    return _contracts(svc, buckets, 1, "")


def build_sharded_registry(svc, buckets=((1, 8), (8, 8))) -> list[EndpointContract]:
    """Contracts for a ``ShardedRetrievalService``: each kernel once per
    shard in every program."""
    return _contracts(svc, buckets, svc.n_shards, "docs")


def audit_trace(trace, contract: EndpointContract) -> list[Violation]:
    """Check one ``ProgramTrace`` against one contract."""
    out = []
    key = contract.key
    got = trace.launches()
    for name in sorted(set(contract.launches) | set(got)):
        want, n = contract.launches.get(name, 0), got.get(name, 0)
        if n != want:
            out.append(Violation(key, "launches", (
                f"{name}: expected exactly {want} call(s) per program, recorded {n}"
            )))
    if trace.host_sync is not None:
        out.append(Violation(key, "host_sync", (
            f"the program synchronised with the host ({trace.host_sync}); every batch "
            f"would wait on the device, and no graph can capture it"
        )))
    if trace.graph is not None:
        nodes = trace.graph.kernels
        for name in sorted(WRAPPERS):
            kernel = kernel_of(name)
            if nodes.get(kernel, 0) != got.get(name, 0):
                out.append(Violation(key, "graph_kernels", (
                    f"{nodes.get(kernel, 0)} {kernel} node(s) in the captured graph, "
                    f"{got.get(name, 0)} recorded {name} call(s)"
                )))
        for kernel in sorted(nodes):
            if "nccl" in kernel.lower() and kernel not in contract.collectives_allowed:
                out.append(Violation(key, "collective", (
                    f"{nodes[kernel]} {kernel} node(s) in the graph; this endpoint allows "
                    f"{', '.join(contract.collectives_allowed) or 'none'}"
                )))
    for i, dtype in enumerate(trace.output_dtypes):
        if dtype in WIDE_DTYPES:
            out.append(Violation(key, "wide_dtype", (
                f"output {i} is {dtype}: the serving ABI is int32/float32; cast at the source"
            )))
    for call in trace.calls:
        wide = sorted({d for d in call.dtypes if d in WIDE_DTYPES})
        if wide:
            out.append(Violation(key, "wide_dtype", (
                f"{call.name} was called with a {'/'.join(wide)} operand: its kernel "
                f"reads int32/float32"
            )))
    return out


def _audit_contracts(svc, registry, program_kw) -> tuple[list, list[Violation]]:
    audited, violations = [], []
    for contract in registry:
        B, m = contract.bucket
        trace = svc.trace_endpoint(contract.kind, B, m, **program_kw)
        vs = audit_trace(trace, contract)
        violations.extend(vs)
        audited.append({
            "contract": contract.key,
            "expected_launches": {k: n for k, n in contract.launches.items() if n},
            "launches": trace.launches(),
            "output_dtypes": list(trace.output_dtypes),
            "graph_nodes": trace.graph.as_dict() if trace.graph is not None else None,
            "ok": not vs,
        })
    return audited, violations


def audit_service(svc, buckets=((1, 8), (8, 8)), **program_kw) -> tuple[dict, list[Violation]]:
    """Audit every (kind x bucket) program of a flat service.  Returns
    (report, violations); the report lists each program's measured
    launches, output dtypes and graph nodes, so it doubles as a record of
    the graphs' sizes.  ``program_kw`` (``max_df``, ``k``, ``max_buf``,
    ``conjunctive``) goes to ``endpoint_program``."""
    registry = build_registry(svc, buckets)
    audited, violations = _audit_contracts(svc, registry, program_kw)
    report = {
        "device": svc.device.type,
        "contracts_audited": len(registry),
        "endpoints": audited,
        "violations": [v.as_dict() for v in violations],
    }
    return report, violations


def audit_sharded_service(svc, buckets=((1, 8), (8, 8)),
                          **program_kw) -> tuple[dict, list[Violation]]:
    """Audit a ``ShardedRetrievalService``: the per-shard launch contracts,
    the graph's kernel nodes and the no-collective rule."""
    registry = build_sharded_registry(svc, buckets)
    audited, violations = _audit_contracts(svc, registry, program_kw)
    report = {
        "mesh_axis": "docs",
        "n_shards": svc.n_shards,
        "device": svc.device.type,
        "contracts_audited": len(registry),
        "endpoints": audited,
        "violations": [v.as_dict() for v in violations],
    }
    return report, violations
