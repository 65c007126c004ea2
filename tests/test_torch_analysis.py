"""The port's analysis gate (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

Under the JAX this suite runs, the reference's jaxpr walker fails
(``jax.core.Jaxpr`` is gone), but its contract registries and its whole
AST lint run.  So:

* the port's registries and measured launches are held to the
  reference's ``pallas_calls`` on the reference's audit collection
  (``version``, n_base 2, n_variants 4, base_len 60, seed 7), flat and as
  4 document shards: the port's calls of the TPU kernels' counterparts
  (backward search + ILCP listing) equal the reference's kernel launches,
  and no endpoint calls rank or RMQ;
* every audit check catches a seeded fault, on the CPU route (the plain
  versions); the CUDA graph checks read a DOT text cut from a real
  ``CUDAGraph.debug_dump`` of the port's tf-idf program on an H100;
* both linters give the same (rule, line, qualname) on the reference's
  rule fixtures and the same RT001 and FJ001 verdicts on ``src/repro``;
  the torch fixtures, the allowlist, the port's tree and the CLI.
"""

import functools
import json
import pathlib
import textwrap
import time

import pytest
import torch

from repro.analysis import contracts as jcontracts
from repro.analysis import lint as jlint
from repro.data.collections import SyntheticSpec, generate
from repro.dist.sharding import make_docs_mesh as jmesh
from repro.serve.retrieval import RetrievalService as JService
from repro_torch.analysis import contracts, lint, programs
from repro_torch.analysis.report import AUDIT_SHARDS, build_audit_services, run
from repro_torch.core import pdl as tpdl
from repro_torch.core.suffix import Collection
from repro_torch.dist.sharding import make_docs_mesh
from repro_torch.kernels import backward_search as tbs
from repro_torch.kernels._record import record_calls
from repro_torch.kernels.pdl_gather import pdl_gather_plain
from repro_torch.kernels.rmq import rmq
from repro_torch.serve.retrieval import RetrievalService


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
AUDIT_SPEC = SyntheticSpec("version", n_base=2, n_variants=4, base_len=60,
                           mutation_rate=0.01, seed=7)
BUCKETS = ((1, 8), (8, 8))
COUNTERPARTS = ("backward_search", "ilcp_list")  # of the reference's Pallas kernels


@pytest.fixture(scope="module")
def ref_registries():
    coll = generate(AUDIT_SPEC)
    flat = JService.build(coll, validate=False)
    sharded = JService.build(coll, mesh=jmesh(AUDIT_SHARDS), validate=False)
    return {"flat": jcontracts.build_registry(flat, BUCKETS),
            "sharded": jcontracts.build_sharded_registry(sharded, BUCKETS)}


@pytest.fixture(scope="module")
def services():
    flat, sharded = build_audit_services("cpu")
    return {"flat": flat, "sharded": sharded}


@pytest.fixture(scope="module")
def cli_report(tmp_path_factory):
    """The CLI on the CPU, run once: its exit code and JSON report."""
    out = tmp_path_factory.mktemp("cli") / "report.json"
    rc = run(["--device", "cpu", "--report", str(out)])
    return rc, json.loads(out.read_text())


def _port_registry(services, which):
    build = contracts.build_registry if which == "flat" else contracts.build_sharded_registry
    return build(services[which], BUCKETS)


# ---------------------------------------------------------------------------
# Contracts against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["flat", "sharded"])
def test_registry_counterparts_equal_pallas_calls(ref_registries, services, which):
    ref = {(c.kind, c.bucket): c.pallas_calls for c in ref_registries[which]
           if c.backend == "kernel"}
    port = {(c.kind, c.bucket): c for c in _port_registry(services, which)}
    assert set(port) == set(ref) and len(port) == 4 * len(BUCKETS)
    for key, c in port.items():
        assert sum(c.launches[k] for k in COUNTERPARTS) == ref[key], key
        assert c.launches["rank"] == c.launches["rmq"] == 0
        assert c.device == "cpu" and c.collectives_allowed == ()
        assert c.mesh_axis == ("docs" if which == "sharded" else "")


@pytest.mark.parametrize("which", ["flat", "sharded"])
def test_measured_launches_equal_pallas_calls(ref_registries, cli_report, which):
    rc, report = cli_report
    assert rc == 0 and report["ok"] is True
    section = report["contracts" if which == "flat" else "contracts_sharded"]
    assert section["contracts_audited"] == 8 and section["violations"] == []
    pre = "docs:" if which == "sharded" else ""
    ref = {f"{pre}{c.kind}/B{c.bucket[0]}xm{c.bucket[1]}/cpu": c.pallas_calls
           for c in ref_registries[which] if c.backend == "kernel"}
    got = {e["contract"]: e for e in section["endpoints"]}
    assert set(got) == set(ref)
    S = AUDIT_SHARDS if which == "sharded" else 1
    for key, e in got.items():
        assert e["ok"] and e["launches"] == e["expected_launches"], key
        assert sum(e["launches"].get(k, 0) for k in COUNTERPARTS) == ref[key], key
        assert not {"rank", "rmq"} & set(e["launches"]), key
        assert e["launches"].get("pdl_gather", 0) == (0 if "plan/" in key else S), key
        assert set(e["output_dtypes"]) <= {"int32", "float32"}, key
        assert e["graph_nodes"] is None  # CPU tensors: no graph
    if which == "sharded":
        assert section["n_shards"] == AUDIT_SHARDS


@pytest.mark.parametrize("which", ["flat", "sharded"])
def test_audit_clean_and_counts_untouched(services, monkeypatch, which):
    """A clean audit on the CPU route, which leaves every wrapper's
    counters as it found them (stand-in plain versions count launches as
    the card's wrappers do)."""
    def counting(*a, **kw):
        tbs.backward_search.launches += 1
        return plain(*a, **kw)

    plain = tbs.backward_search_plain
    monkeypatch.setattr(tbs, "backward_search_plain", counting)
    before = {name: w.launches for name, w in programs.WRAPPERS.items()}
    audit = contracts.audit_service if which == "flat" else contracts.audit_sharded_service
    report, violations = audit(services[which], buckets=((2, 8),))
    assert violations == [] and report["contracts_audited"] == 4
    assert {name: w.launches for name, w in programs.WRAPPERS.items()} == before
    services[which].plan(["ab"])  # outside an audit the stand-in counts, once a shard
    assert tbs.backward_search.launches == \
        before["backward_search"] + getattr(services[which], "n_shards", 1)


def _plan_contract(**launches):
    want = {k: 0 for k in contracts.ENDPOINT_KERNELS}
    want.update(launches)
    return contracts.EndpointContract("plan", (1, 8), "cpu", want)


def _seeded(svc, case, monkeypatch):
    """(trace, contract) of one seeded fault."""
    fn, args = svc.endpoint_program("plan")
    plan = _plan_contract(backward_search=1)
    if case == "double_search":
        return programs.trace_program("plan", (1, 8), lambda *a: (fn(*a), fn(*a)),
                                      args(1, 8)), plan
    if case == "dropped_gather":
        monkeypatch.setattr(tpdl, "pdl_gather", pdl_gather_plain)  # the wrapper skipped
        return svc.trace_endpoint("topk", 1, 8), contracts.build_registry(svc, ((1, 8),))[2]
    if case == "int64_output":
        return programs.trace_program(
            "plan", (1, 8), lambda *a: fn(*a).lo.long(), args(1, 8)), plan
    if case == "float64_operand":
        table = svc.ilcp.rmq.table
        vals = svc.ilcp.vilcp.double()
        lo = torch.zeros(1, dtype=torch.int32)
        return (programs.trace_program("rmq", (1, 8), lambda lo: rmq(vals, table, lo, lo), (lo,)),
                _plan_contract(backward_search=0, rmq=1))
    if case == "one_launch_too_many":
        return svc.trace_endpoint("plan", 1, 8), _plan_contract(backward_search=2)
    raise AssertionError(case)


@pytest.mark.parametrize("case,check,word", [
    ("double_search", "launches", "backward_search: expected exactly 1 call(s) per program, "
                                  "recorded 2"),
    ("dropped_gather", "launches", "pdl_gather: expected exactly 1 call(s) per program, "
                                   "recorded 0"),
    ("int64_output", "wide_dtype", "output 0 is int64"),
    ("float64_operand", "wide_dtype", "rmq was called with a float64 operand"),
    ("one_launch_too_many", "launches", "expected exactly 2 call(s) per program, recorded 1"),
])
def test_audit_catches_seeded_fault(services, monkeypatch, case, check, word):
    trace, contract = _seeded(services["flat"], case, monkeypatch)
    vs = contracts.audit_trace(trace, contract)
    assert [v.check for v in vs] == [check], [v.as_dict() for v in vs]
    assert word in vs[0].message and vs[0].contract == contract.key


def test_graph_checks_catch_uncounted_kernel_and_nccl(services):
    """On the card the graph's kernel nodes must equal the recorded calls,
    and no NCCL kernel may appear: a trace whose graph holds one more
    backward search than was recorded, and an NCCL all-reduce."""
    good = services["flat"].trace_endpoint("plan", 1, 8)
    graph = programs.GraphNodes(
        kernels={"backward_search_kernel": 2, "vectorized_elementwise_kernel": 40,
                 "ncclDevKernel_AllReduce_Sum_f32_RING_LL": 1}, copies=0, total=43)
    bad = programs.ProgramTrace("plan", (1, 8), "cuda", good.calls, good.output_dtypes, graph)
    contract = contracts.EndpointContract("plan", (1, 8), "cuda",
                                          _plan_contract(backward_search=1).launches)
    vs = contracts.audit_trace(bad, contract)
    assert [v.check for v in vs] == ["graph_kernels", "collective"], [v.as_dict() for v in vs]
    ok = programs.GraphNodes(kernels={"backward_search_kernel": 1}, copies=0, total=1)
    synced = programs.ProgramTrace("plan", (1, 8), "cuda", good.calls, good.output_dtypes, ok,
                                   host_sync="called a synchronizing CUDA operation")
    assert [v.check for v in contracts.audit_trace(synced, contract)] == ["host_sync"]


def test_registry_skips_kinds_without_topk_index():
    coll = generate(AUDIT_SPEC)
    svc = RetrievalService.build(Collection(text=coll.text, doc_starts=coll.doc_starts,
                                            doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma),
                                 topk_index=False, validate=False, device="cpu")
    assert [c.kind for c in contracts.build_registry(svc, ((32, 8),))] == ["plan", "list"]
    with pytest.raises(ValueError, match="top-k PDL"):
        svc.endpoint_program("topk")
    with pytest.raises(ValueError, match="unknown endpoint kind"):
        svc.endpoint_program("count")


@pytest.mark.parametrize("which", ["flat", "sharded"])
def test_endpoint_program_is_what_serves(which):
    """With the Brute-L window pinned to the audit's, the cached program of
    each kind is built from the same builder and statics as the audited
    one."""
    coll = generate(AUDIT_SPEC)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts, doc_ends=coll.doc_ends,
                       d=coll.d, sigma=coll.sigma)
    mesh = make_docs_mesh(AUDIT_SHARDS, "cpu") if which == "sharded" else None
    svc = RetrievalService.build(tcoll, brute_window=32, validate=False, device="cpu", mesh=mesh)
    pats = ["ab", "ba", "abab"]
    svc.plan(pats)
    svc.list_docs_arrays(pats, max_df=64, max_buf=512)
    svc.topk_arrays(pats, k=10, max_buf=512)
    svc.tfidf_arrays([["ab", "ba"]], k=10, max_buf=512)
    cached = {kind: prog.fn for (kind, _), prog in svc.compiled_programs().items()}
    for kind in svc.ENDPOINT_KINDS:
        fn, args = svc.endpoint_program(kind)
        assert isinstance(fn, functools.partial) and fn.func is cached[kind].func, kind
        assert len(fn.args) == len(cached[kind].args), kind
        assert all(a is b or a == b for a, b in zip(fn.args, cached[kind].args)), kind
        assert args(2, 5)[0].shape[-1] == 8


def test_injected_clock_times_builds():
    """``build_seconds`` read the injected clock (RT001's repair)."""
    ticks = iter(range(1000))

    def clock():
        return float(next(ticks))

    coll = generate(SyntheticSpec("version", n_base=1, n_variants=3, base_len=30,
                                  mutation_rate=0.01, seed=1))
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts, doc_ends=coll.doc_ends,
                       d=coll.d, sigma=coll.sigma)
    svc = RetrievalService.build(tcoll, device="cpu", clock=clock)
    assert svc.build_seconds == {k: 1.0 for k in ("suffix", "csa", "ilcp", "pdl", "pdl_topk",
                                                  "sada", "validate")}
    sharded = RetrievalService.build(tcoll, mesh=make_docs_mesh(2, "cpu"), device="cpu",
                                     clock=clock)
    assert sharded.build_seconds == {"shard0": 13.0, "shard1": 13.0, "validate": 1.0}
    assert sharded.shards[0].build_seconds["csa"] == 1.0
    before = time.perf_counter()
    assert 0 <= RetrievalService.build(tcoll, device="cpu").build_seconds["csa"] <= \
        time.perf_counter() - before


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


def test_recorder(services):
    svc = services["flat"]
    fn, args = svc.endpoint_program("plan")
    a = args(2, 8)
    fn(*a)  # no recorder open: nothing to record into
    with record_calls() as outer:
        assert outer == []
        with record_calls() as inner:
            fn(*a)
        fn(*a)
    fn(*a)
    assert [c.name for c in inner] == ["backward_search"]
    assert [c.name for c in outer] == ["backward_search", "backward_search"]
    call = outer[0]
    assert set(call.dtypes) == {"int32"} and set(call.devices) == {"cpu"}
    assert len(call.dtypes) == 6  # words, ones_prefix, zcount, base, patterns, lengths
    with record_calls() as calls:
        tbs.backward_search(*[torch.zeros((0, 0), dtype=torch.int32)] * 2,
                            *[torch.zeros(0, dtype=torch.int32)] * 2,
                            torch.zeros((0, 8), dtype=torch.int32),
                            torch.zeros(0, dtype=torch.int32), n=1, sigma=0)
    assert calls == []  # a closed-form empty answer launches nothing and records nothing


# ---------------------------------------------------------------------------
# The CUDA graph's DOT text
# ---------------------------------------------------------------------------

#: cut from ``CUDAGraph.debug_dump`` of the port's tf-idf program (audit
#: collection, bucket (1, 8)) on an NVIDIA H100 80GB HBM3, torch 2.11.0,
#: CUDA 12.8: five of its 159 nodes and two of its edges
DOT = r'''digraph dot {
subgraph cluster_4 {
label="graph_4" graph[style="dashed"];
"graph_4_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 157) | _ZN53_GLOBAL__N__5d903e8a_20_retrieval_kernels_cu_585c1ca922backward_search_kernelEPKiS1_S1_S1_S1_S1_PiS2_iiiiii\<\<\<1,128,0\>\>\>}
| {{node handle | func handle} | {0x00000000189137E8 | 0x00000000188DB510}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_4_node_8"[style="bold" shape="record" label="{KERNEL
| {ID | 8 (topoId: 150) | _ZN53_GLOBAL__N__5d903e8a_20_retrieval_kernels_cu_585c1ca917pdl_gather_kernelEN2rt7CsaViewENS0_7PdlViewEPKiS4_PiS5_S5_ii\<\<\<2,256,19500\>\>\>}
| {{node handle | func handle} | {0x0000000018910410 | 0x00000000188C9FF0}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_4_node_13"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {13 (topoId: 145) | 0x000000001890DF08}}
| {kind | DtoD (DEVICE to DEVICE)}
| {{srcPtr | dstPtr} | {pitch | ptr | xsize | ysize | pitch | ptr | xsize | ysize} | {0 | 0x00007F30AC803800 | 0 | 0 | 0 | 0x00007F30AC804800 | 0 | 0}}
| {{srcPos | {{x | 0} | {y | 0} | {z | 0}}} | {dstPos | {{x | 0} | {y | 0} | {z | 0}}} | {Extent | {{Width | 4096} | {Height | 1} | {Depth | 1}}}}
}"];

"graph_4_node_14"[style="bold" shape="record" label="{KERNEL
| {ID | 14 (topoId: 144) | _ZN50_GLOBAL__N__fa15d16e_17_RangeFactories_cu_38772b0829elementwise_kernel_with_indexIiZZZN2at6native15arange_cuda_outERKN3c106ScalarES6_S6_RNS1_6TensorEENKUlvE_clEvENKUlvE2_clEvEUllE_EEvT_T0_PN15function_traitsISD_E11result_typeE\<\<\<8,64,0\>\>\>}
| {{node handle | func handle} | {0x000000001890C8D0 | 0x0000000010B19A30}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_4_node_17"[style="bold" shape="record" label="{KERNEL
| {ID | 17 (topoId: 141) | _ZN2at6native18radixSortKVInPlaceILi2ELin1ELi32ELi32EiljEEvNS_4cuda6detail10TensorInfoIT3_T5_EES6_S6_S6_NS4_IT4_S6_EES6_b\<\<\<2,32,0\>\>\>}
| {{node handle | func handle} | {0x000000001890C168 | 0x0000000009DD1630}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_4_node_12" -> "graph_4_node_13" [headlabel=0];
"graph_4_node_13" -> "graph_4_node_14" [headlabel=0];
}
}
'''


def test_parse_graph_dot():
    nodes = programs.parse_graph_dot(DOT)
    assert nodes.kernels == {"backward_search_kernel": 1, "pdl_gather_kernel": 1,
                             "elementwise_kernel_with_index": 1, "radixSortKVInPlace": 1}
    assert (nodes.copies, nodes.total, nodes.kernel_nodes) == (1, 5, 4)
    assert programs.parse_graph_dot("digraph dot {\n}\n") == programs.GraphNodes({}, 0, 0)
    # a kernel node whose label holds no mangled symbol counts under "?"
    odd = '"n0"[shape="record" label="{KERNEL | {ID | 0 | k\\<\\<\\<1,1,0\\>\\>\\>}}"];'
    assert programs.parse_graph_dot(odd) == programs.GraphNodes({"?": 1}, 0, 1)


@pytest.mark.parametrize("symbol,name", [
    # the ILCP kernel's template instance on a stored DA (list program, same run)
    ("_ZN53_GLOBAL__N__5d903e8a_20_retrieval_kernels_cu_585c1ca916ilcp_list_kernelIN2rt8"
     "DaStoredEEEvPKiS4_S4_T_S4_S4_PiS6_iiii", "ilcp_list_kernel"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_15CUDAFunctor_addIiEESt5arrayIPc"
     "Lm3EEEEviT0_T1_", "vectorized_elementwise_kernel"),
    ("_Z12empty_kernelv", "empty_kernel"),
    ("_ZL10rmq_kernelPKiS0_S0_S0_Piiii", "rmq_kernel"),
])
def test_kernel_base_name(symbol, name):
    assert programs.kernel_base_name(symbol) == name


# ---------------------------------------------------------------------------
# The AST lint
# ---------------------------------------------------------------------------


def _lint(linter, tmp_path, rel, source):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return linter.lint_file(path, rel)


#: the reference's rule fixtures (``tests/test_analysis.py``): rel path,
#: source, the rules they raise
SHARED_FIXTURES = {
    "rt001_clock": ("serve/bad_runtime.py", """
        import time

        def tick():
            return time.monotonic()
    """, ["RT001"]),
    "rt001_injected": ("serve/good_runtime.py", """
        import time

        def tick(clock=time.monotonic):
            return clock()
    """, []),
    "tr001_item_and_cast": ("serve/bad_exec.py", """
        def scores_batch(x, lens):
            n = int(lens)
            return x.sum().item() + n
    """, ["TR001", "TR001"]),
    "tr001_branch": ("kernels/bad_kernel.py", """
        def descend(lo, hi, words):
            if lo > 0:
                return hi
            return lo
    """, ["TR001"]),
    "tr001_static_shape": ("kernels/good_kernel.py", """
        def descend(lo, hi, words, block=None):
            if words.shape[0] > 4 and block is None:
                return hi
            return lo
    """, []),
    "tr001_keyword_knob": ("serve/good_exec.py", """
        def scores_batch(x, lens, *, use_kernel=True):
            if use_kernel:
                return x
            return x + 1
    """, []),
    "fj001_outside": ("core/bad_core.py", """
        from repro.serve import faults

        def lookup(x):
            faults.fire("lookup")
            return x
    """, ["FJ001"]),
    "fj001_reference_path": ("serve/retrieval.py", """
        from repro.serve import faults

        def plan_reference(x):
            faults.fire("plan")
            return x
    """, ["FJ001"]),
    "fj001_direct_error": ("serve/bad_site.py", """
        from repro.serve.faults import FaultInjectedError

        def go():
            raise FaultInjectedError("boom")
    """, ["FJ001"]),
}


@pytest.mark.parametrize("name", sorted(SHARED_FIXTURES))
def test_lint_fixture_same_as_reference(tmp_path, name):
    rel, source, rules = SHARED_FIXTURES[name]
    got = _lint(lint, tmp_path / "port", rel, source)
    want = _lint(jlint, tmp_path / "ref", rel, source)
    assert sorted(v.rule for v in got) == sorted(rules)
    assert [(v.rule, v.line, v.qualname) for v in got] == \
        [(v.rule, v.line, v.qualname) for v in want]


@pytest.mark.parametrize("source,rules", [
    ("def rows_batch(x, lens):\n    return x.tolist()\n", ["TR001"]),
    ("def rows_batch(x, lens):\n    return x.cpu()\n", ["TR001"]),
    ("def rows_batch(x, lens):\n    return x.numpy()\n", ["TR001"]),
    ("def rows_batch(x, lens):\n    return bool(lens)\n", ["TR001"]),
    ("def rows_batch(x, lens):\n    return x if x.any() else lens\n", ["TR001"]),
    ("def rows_batch(x, lens):\n"
     "    if x.size(0) and x.numel() and x.dim() == 2 and x.is_cuda and lens.ndim:\n"
     "        return x.device, lens.dtype\n"
     "    return lens.shape\n", []),
    ("def rows_batch(x, lens, *, k):\n    return x[:k] if k else lens\n", []),
])
def test_tr001_torch_fixtures(tmp_path, source, rules):
    assert [v.rule for v in _lint(lint, tmp_path, "core/rows.py", source)] == rules


@pytest.mark.parametrize("source,lines", [
    ("import torch\nx = torch.zeros(3)\nif torch.cuda.is_available():\n"
     "    n = torch.cuda.device_count()\n", []),
    ("import torch\ntorch.cuda.synchronize()\n", [2]),
    ("import torch\nx = torch.zeros(3).cuda()\n", [2]),
    ("import torch\nx = torch.zeros(3, device='cuda')\n"
     "y = torch.ones(2, device=torch.device('cuda:0'))\n", [2, 3]),
    ("from repro_torch.kernels import _build\nLIB = _build.library()\n", [2]),
    ("from repro_torch.kernels._build import build as b\nPATH = b()\n", [2]),
    ("import torch\nfor _ in range(2):\n    torch.cuda.empty_cache()\n", [3]),
    ("import torch\n\ndef f():\n    torch.cuda.synchronize()\n    return torch.zeros(1).cuda()\n\n"
     "class C:\n    x = staticmethod(lambda: torch.zeros(1, device='cuda'))\n", []),
])
def test_jx001_torch_fixtures(tmp_path, source, lines):
    vs = _lint(lint, tmp_path, "core/mod.py", source)
    assert [(v.rule, v.line, v.qualname) for v in vs] == [("JX001", ln, "<module>")
                                                           for ln in lines]


def test_allowlist_suppresses_named_entry(tmp_path):
    vs = _lint(lint, tmp_path, "serve/noisy.py",
               "import time\n\ndef tick():\n    return time.time()\n")
    assert [v.rule for v in vs] == ["RT001"]
    assert all(lint._allowed(v, {"RT001": ["serve/noisy.py:tick"]}) for v in vs)
    assert all(lint._allowed(v, {"RT001": ["serve/noisy.py"]}) for v in vs)
    assert not any(lint._allowed(v, {"RT001": ["serve/other.py"]}) for v in vs)
    assert not any(lint._allowed(v, {"TR001": ["serve/noisy.py"]}) for v in vs)


def test_port_tree_clean_and_allowlist_justified():
    violations, stats = lint.lint_tree(PORT)
    assert violations == [], [v.as_dict() for v in violations]
    assert stats["files_scanned"] > 50 and stats["rules"] == ["FJ001", "JX001", "RT001", "TR001"]
    bare, _ = lint.lint_tree(PORT, allowlist={})
    assert [v for v in bare if v.rule != "TR001"] == []  # no clock call left under serve/
    allow = lint._load_allowlist()
    assert set(allow) == {"TR001"}
    readme = (ROOT / "README.md").read_text()
    for entry in allow["TR001"]:
        # each entry still suppresses a finding, and the README gives its reason
        assert any(f"{v.path}:{v.qualname}" == entry for v in bare), entry
        assert f"`{entry}`" in readme, entry


def test_reference_tree_same_verdicts():
    ours, _ = lint.lint_tree(REF, allowlist={})
    theirs, _ = jlint.lint_tree(REF, allowlist={})

    def key(vs):
        return sorted((v.rule, v.path, v.line, v.qualname) for v in vs
                      if v.rule in ("RT001", "FJ001"))

    assert key(ours) == key(theirs)


def test_cli_lint_only(tmp_path):
    out = tmp_path / "report.json"
    assert run(["--lint-only", "--report", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] is True and report["lint"]["violations"] == []
    assert "contracts" not in report
    bad = tmp_path / "tree" / "serve" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import time\n\ndef tick():\n    return time.sleep(1)\n")
    assert run(["--lint-only", "--root", str(tmp_path / "tree"), "--report", str(out)]) == 1
    report = json.loads(out.read_text())
    assert report["ok"] is False
    assert [v["rule"] for v in report["lint"]["violations"]] == ["RT001"]


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        run([])
