"""One endpoint program, run once and recorded: the port's counterpart of
the reference's jaxpr (``repro.analysis.jaxpr``).

A jaxpr shows a program's primitives before anything runs.  A torch
program has no such form, so ``trace_program`` runs it once at one bucket
and records what it did:

* the kernel wrappers it called, in order, with their operands' dtypes
  and devices (``repro_torch.kernels._record``);
* the dtypes of its outputs;
* on CUDA tensors, the nodes of the CUDA graph it captures into: kernel
  nodes by kernel name, memcpy and memset nodes, and all nodes.  The
  program is captured afresh into a graph in debug mode, apart from the
  service's program cache (as the reference traces apart from its compile
  cache), after a warm-up run on a side stream under
  ``torch.cuda.set_sync_debug_mode("error")``, as ``Program._capture``
  warms up; the capture itself refuses a host sync.  The graph is written
  with ``debug_dump`` and its DOT text parsed.

Every wrapper's launch counters and the process-wide sync debug mode are
restored afterwards: an audit leaves no trace in the counts.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import re
import tempfile

import torch

from repro_torch.kernels._record import dtype_name, record_calls, tensors_of
from repro_torch.kernels.backward_search import backward_search
from repro_torch.kernels.ilcp_list import ilcp_list
from repro_torch.kernels.pdl_gather import pdl_gather
from repro_torch.kernels.rank import rank
from repro_torch.kernels.rmq import rmq
from repro_torch.kernels.sada_c_list import sada_c_list
from repro_torch.kernels.wt_list import wt_list

#: every counted wrapper, by its recorded name; its CUDA kernel is
#: ``<name>_kernel`` (``csrc/retrieval_kernels.cu``)
WRAPPERS = {w.__name__: w for w in (backward_search, ilcp_list, pdl_gather, rank, rmq,
                                    sada_c_list, wt_list)}
_COUNTERS = ("launches", "csa_launches")


def kernel_of(name: str) -> str:
    """The CUDA kernel's base name of a recorded wrapper name."""
    return f"{name}_kernel"


@dataclasses.dataclass(frozen=True)
class GraphNodes:
    """The nodes of one captured CUDA graph."""

    kernels: dict   # kernel base name -> kernel nodes
    copies: int     # memcpy and memset nodes
    total: int      # all nodes

    @property
    def kernel_nodes(self) -> int:
        return sum(self.kernels.values())

    def as_dict(self) -> dict:
        return {"total": self.total, "kernel": self.kernel_nodes, "memcpy_memset": self.copies,
                "kernels": dict(sorted(self.kernels.items()))}


@dataclasses.dataclass(frozen=True)
class ProgramTrace:
    """What one run of an endpoint program at one bucket did."""

    kind: str
    bucket: tuple
    device: str                # "cuda" or "cpu"
    calls: tuple               # KernelCall per wrapper call, in order
    output_dtypes: tuple       # of every output tensor, in order
    graph: GraphNodes | None   # CUDA tensors only
    #: the sync debug mode's error, where the warm-up synchronised with
    #: the host (then nothing was captured)
    host_sync: str | None = None

    def launches(self) -> dict:
        """Recorded calls per wrapper name."""
        return dict(collections.Counter(c.name for c in self.calls))


# ---------------------------------------------------------------------------
# The CUDA graph's DOT text
# ---------------------------------------------------------------------------

_EDGE = re.compile(r'"[^"]*"\s*->\s*"[^"]*"')
_NODE = re.compile(r'"(?P<id>[^"]+)"\s*\[(?P<attrs>(?:[^"\]]|"(?:[^"\\]|\\.)*")*)\]')
_LABEL = re.compile(r'label\s*=\s*"(?P<label>(?:[^"\\]|\\.)*)"', re.S)
_MANGLED = re.compile(r"_Z[\w$]+")
_IDENT = re.compile(r"\d+")


def kernel_base_name(symbol: str) -> str:
    """The base name of a kernel's symbol: ``backward_search_kernel`` for
    ``_ZN12_GLOBAL__N_122backward_search_kernelEPKi...``, ``ilcp_list_kernel``
    for a template instance, ``vectorized_elementwise_kernel`` for
    ``_ZN2at6native29vectorized_elementwise_kernelILi4E...``: the last
    name of the (nested) name, before any template arguments."""
    i = 2 + (symbol[2:3] == "L")
    nested = symbol[i:i + 1] == "N"
    i += nested
    last = None
    while i < len(symbol):
        m = _IDENT.match(symbol, i)
        if m is None:
            break  # template arguments, the end of the name, or its parameters
        n = int(m.group())
        i = m.end()
        last = symbol[i:i + n]
        i += n
        if not nested:
            break
    return last or symbol


def parse_graph_dot(text: str) -> GraphNodes:
    """Node counts of a ``CUDAGraph.debug_dump`` DOT text.  A node's type is
    the first of KERNEL, MEMCPY or MEMSET its label names; a kernel node's
    name is the first mangled symbol of its label (the function name and
    nothing else is read: the rest of a label differs between CUDA
    versions); a kernel node without one counts as ``"?"``, which no
    contract matches."""
    kernels: collections.Counter = collections.Counter()
    copies = total = 0
    for node in _NODE.finditer(_EDGE.sub("", text)):
        label = _LABEL.search(node.group("attrs"))
        if label is None:
            continue  # graph, node or edge defaults
        total += 1
        body = label.group("label")
        kind = re.search(r"\b(KERNEL|MEMCPY|MEMSET)\b", body.upper())
        if kind is None:
            continue
        if kind.group(1) != "KERNEL":
            copies += 1
            continue
        sym = _MANGLED.search(body)
        kernels[kernel_base_name(sym.group()) if sym else "?"] += 1
    return GraphNodes(kernels=dict(kernels), copies=copies, total=total)


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


def _counts():
    return {(name, c): getattr(w, c) for name, w in WRAPPERS.items() for c in _COUNTERS
            if hasattr(w, c)}


def _restore(counts):
    for (name, c), v in counts.items():
        setattr(WRAPPERS[name], c, v)


def _is_sync_error(e: RuntimeError) -> bool:
    return "synchronizing" in str(e)


def _graph_nodes(fn, inputs) -> GraphNodes:
    """Capture ``fn`` on ``inputs`` into a debug-mode graph and parse its
    dump.  The graph is kept uninstantiated (``keep_graph=True``): it is
    read, never replayed, and ``debug_dump`` needs the captured graph."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn(*inputs)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        if not os.path.exists(path):
            raise RuntimeError("CUDAGraph.debug_dump wrote no DOT file")
        with open(path) as f:
            text = f.read()
    return parse_graph_dot(text)


def trace_program(kind: str, bucket: tuple, fn, args) -> ProgramTrace:
    """Run ``fn(*args)`` once, recorded; on CUDA tensors also capture it and
    count its graph's nodes.  ``bucket`` is the (batch, length) bucket the
    arguments pad to, for the report."""
    dev = args[0].device
    counts = _counts()
    try:
        if dev.type != "cuda":
            with record_calls() as calls:
                out = fn(*args)
            return ProgramTrace(kind, tuple(bucket), dev.type, tuple(calls),
                                tuple(dtype_name(t) for t in tensors_of(out)), None)
        inputs = tuple(a.clone() for a in args)
        mode = torch.cuda.get_sync_debug_mode()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            torch.cuda.set_sync_debug_mode("error")
            with torch.cuda.stream(side), record_calls() as calls:
                out = fn(*inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = _graph_nodes(fn, inputs)
            sync = None
        except RuntimeError as e:
            if not _is_sync_error(e):
                raise
            torch.cuda.current_stream(dev).wait_stream(side)
            out, graph, sync = (), None, str(e)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        return ProgramTrace(kind, tuple(bucket), dev.type, tuple(calls),
                            tuple(dtype_name(t) for t in tensors_of(out)), graph, sync)
    finally:
        _restore(counts)
