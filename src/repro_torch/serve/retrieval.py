"""Batched document-retrieval serving: ``plan``, ``count``, ``list_docs``,
``topk`` and ``tfidf`` (counterpart of ``repro.serve.retrieval``).

One service object owns the index stack over a collection: CSA, ILCP,
PDL in listing mode and in top-k mode (``beta=None``, with frequencies),
Sadakane counting (sparse) and the document array.
A query batch runs in three stages:

1. **Planner** (``repro_torch.serve.planner``): backward search through
   the port's kernel, Sada df, occ and a per-query engine code.
2. **Masked batch executors**: Brute-L, ILCP (through the port's listing
   kernel) and PDL each run over the whole batch with the queries not
   assigned to them collapsed to empty ranges; the rows are selected by
   engine and sorted.  ``topk`` sends ILCP-assigned queries to the top-k
   PDL (ILCP has no frequencies); ``tfidf`` runs every term through it.
3. **Shape-bucketed program cache**: batches pad to powers of two and
   pattern lengths to multiples of 8, as in the reference, and ``plan``,
   ``list_docs``, ``topk`` and ``tfidf`` each run as ONE program per
   (kind, statics) bucket, keyed as the reference keys its AOT
   executables.  On the card a program is a CUDA graph: its first call
   runs the program once on a side stream (real launches), captures it
   and replays it; every later call copies the padded batch into the
   graph's static inputs and replays, so the thousands of small kernels of
   the masked executors cost one launch from Python.  ``compile_counts``
   tallies the captures per kind (on CPU tensors the program is the eager
   function, cached and tallied the same way).  The threshold and the
   engine are device inputs, so switching engine reuses the program.  The
   Brute-L window is a static of the bucket, sized from a plan pass (the
   cached ``plan`` program) and grow-only: each growth captures once more.

A capture or replay that fails raises; nothing falls back to eager
execution on the card.  The fault sites of ``repro_torch.serve.faults``
sit where the reference's do, outside every program: ``plan`` before the
plan program, ``compile:<kind>`` on a cache miss before the program is
built or captured, ``executor:<kind>`` after the Brute-L window pass, and
the poison hook on the host arrays.

The reference's per-query loop survives as ``engine="reference"`` (or
``"reference:<engine>"`` to force a sub-engine), the runtime's last
degradation rung and the parity oracle of the batched path: eager, per
query, on the service's device, through the same kernel wrappers (one
backward search per batch, one listing or gather launch per query), with
no program and no fault hook.  ``build`` validates the index by default
(``repro_torch.serve.validate``) and stores its fingerprints.
``build(mesh=...)`` builds the docs-sharded service
(``repro_torch.serve.sharded``).
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.common import BIG, IDX, as_i32, resolve_device
from repro_torch.core.csa import CSA, build_csa, csa_search_batch
from repro_torch.core.ilcp import (
    ILCPIndex,
    build_ilcp,
    ilcp_count_docs_batch,
    ilcp_list_docs_da,
    ilcp_list_docs_da_planned,
)
from repro_torch.core.listing import (
    brute_list_csa,
    brute_list_csa_batch,
    brute_topk,
    brute_topk_batch,
)
from repro_torch.core.pdl import (
    PDLIndex,
    build_pdl,
    pdl_list_docs,
    pdl_list_docs_batch,
    pdl_topk,
    pdl_topk_batch,
)
from repro_torch.core.sada import SadaCount, build_sada, sada_count_batch
from repro_torch.core.suffix import Collection, build_suffix_data
from repro_torch.core.tfidf import term_ranges_batch, tfidf_topk_batch
from repro_torch.data.collections import normalize_patterns, pad_patterns
from repro_torch.kernels.backward_search import backward_search
from repro_torch.kernels.ilcp_list import ilcp_list
from repro_torch.kernels.pdl_gather import pdl_gather
from repro_torch.kernels.rank import rank
from repro_torch.kernels.rmq import rmq
from repro_torch.serve import faults
from repro_torch.serve.planner import (
    ENGINE_BRUTE,
    ENGINE_EMPTY,
    ENGINE_ILCP,
    ENGINE_PDL,
    masked_ranges,
    plan_knobs,
    plan_queries,
)
from repro_torch.serve.trace import StageClock, stage, tracer
from repro_torch.serve.validate import validate_service

# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------


def _bucket_batch(b: int) -> int:
    """Round a batch size up to the next power of two (>= 1)."""
    return 1 if b <= 1 else 1 << (b - 1).bit_length()


def _bucket_len(m: int) -> int:
    """Round a pattern length up to a multiple of 8 (>= 8)."""
    return max(8, -(-m // 8) * 8)


#: smallest dispatch-aware Brute-L window; windows grow in powers of two
#: up to the endpoint's ``max_buf``
BRUTE_WINDOW_FLOOR = 32

#: largest servable pattern length; longer patterns normalize to empty
MAX_PATTERN_LEN = 4096

#: the counters of a plan's rows per engine, indexed by engine code
ENGINE_ROWS = ("service.rows.empty", "service.rows.brute", "service.rows.ilcp",
               "service.rows.pdl")


def _sub_engine(engine: str) -> str:
    """The sub-engine of ``"reference"`` / ``"reference:<engine>"``."""
    return engine.split(":", 1)[1] if ":" in engine else "auto"


def _pow2_ceil(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


#: the least value of each endpoint knob (ROADMAP C17)
_KNOB_FLOORS = {"max_df": 0, "k": 0, "max_buf": 1}


def _require_knobs(**knobs) -> None:
    """Refuse a knob below its floor (``max_df`` and ``k`` below 0,
    ``max_buf`` below 1) with one ``ValueError`` that names it, before any
    engine or program runs.  ``list_docs`` does not pass ``max_buf``: at 0
    the reference answers it, and so does the port."""
    for name, value in knobs.items():
        if value < _KNOB_FLOORS[name]:
            raise ValueError(f"{name} must be >= {_KNOB_FLOORS[name]}, got {value}")


def _sorted_rows(docs):
    """Canonical listing layout: ascending doc ids, -1 padding at the end."""
    s = torch.sort(torch.where(docs < 0, BIG, docs), dim=1).values
    return torch.where(s == BIG, -1, s).to(IDX)


def _list_program(max_df, brute_win, max_buf,
                  csa, ilcp, pdl, da, sada, patterns, lengths, threshold, forced):
    """list_docs for one padded batch: plan, run every engine masked,
    select by engine, sort the rows.  Stages (``serve.trace``): plan,
    brute, ilcp, pdl, select."""
    plan = plan_queries(csa, sada, patterns, lengths, threshold, forced)
    bl, bh = masked_ranges(plan, ENGINE_BRUTE)
    docs_b, cnt_b, _ = brute_list_csa_batch(csa, bl, bh, brute_win, max_df)
    stage("brute")
    il, ih = masked_ranges(plan, ENGINE_ILCP)
    docs_i, cnt_i = ilcp_list_docs_da_planned(ilcp, da, il, ih, max_df)
    stage("ilcp")
    pl, ph = masked_ranges(plan, ENGINE_PDL)
    docs_p, cnt_p = pdl_list_docs_batch(pdl, csa, pl, ph, max_df, max_buf)
    stage("pdl")

    eng = plan.engine[:, None]
    docs = torch.where(eng == ENGINE_BRUTE, docs_b,
                       torch.where(eng == ENGINE_ILCP, docs_i, docs_p))
    docs = torch.where(eng == ENGINE_EMPTY, -1, docs)
    cnt = torch.where(plan.engine == ENGINE_BRUTE, cnt_b,
                      torch.where(plan.engine == ENGINE_ILCP, cnt_i, cnt_p))
    cnt = torch.where(plan.engine == ENGINE_EMPTY, 0, cnt).to(IDX)
    docs = _sorted_rows(docs)
    stage("select")
    return docs, cnt, plan


def _topk_program(k, max_df, brute_win, max_buf,
                  csa, pdl_t, sada, patterns, lengths, threshold, forced):
    """topk for one padded batch: Brute-assigned queries rank their
    sorted occ window; PDL- and ILCP-assigned ones the top-k PDL's lists.
    Stages: plan, brute, pdl, select."""
    plan = plan_queries(csa, sada, patterns, lengths, threshold, forced)
    bl, bh = masked_ranges(plan, ENGINE_BRUTE)
    tb_docs, tb_tf = brute_topk_batch(*brute_list_csa_batch(csa, bl, bh, brute_win, max_df), k)
    stage("brute")
    use_pdl = (plan.engine == ENGINE_PDL) | (plan.engine == ENGINE_ILCP)
    tp_docs, tp_tf = pdl_topk_batch(pdl_t, csa, torch.where(use_pdl, plan.lo, 0),
                                    torch.where(use_pdl, plan.hi, 0), k, max_buf)
    stage("pdl")
    is_brute = (plan.engine == ENGINE_BRUTE)[:, None]
    empty = (plan.engine == ENGINE_EMPTY)[:, None]
    docs = torch.where(empty, -1, torch.where(is_brute, tb_docs, tp_docs)).to(IDX)
    tfs = torch.where(empty, 0, torch.where(is_brute, tb_tf, tp_tf)).to(IDX)
    stage("select")
    return docs, tfs, plan


def _tfidf_program(k, conjunctive, max_buf, csa, pdl_t, sada, patterns, lengths):
    """tfidf for one padded [Q, T, m] batch: one range search over every
    term, then ranked-AND/OR scoring.  Stages: ranges, score."""
    ranges, valid = term_ranges_batch(csa, patterns, lengths)
    stage("ranges")
    out = tfidf_topk_batch(pdl_t, csa, sada, ranges, valid, k, conjunctive, max_buf=max_buf)
    stage("score")
    return out


# ---------------------------------------------------------------------------
# Programs: one per (kind, statics) bucket
# ---------------------------------------------------------------------------

#: the kernel wrappers whose ``launches`` a replay adds to
COUNTED_KERNELS = (backward_search, ilcp_list, pdl_gather, rank, rmq)


class Program:
    """One endpoint program of a shape bucket, called with the padded
    batch's device tensors (the index is bound into ``fn``).

    On CUDA tensors the program is a captured CUDA graph with static input
    tensors of its own and one private memory pool.  Construction runs
    ``fn`` once on a side stream (its launches are real and counted), then
    captures it; each call copies its arguments into the static inputs and
    replays.  The wrappers count launches in Python, which a replay does
    not run: the capture's own increments are undone, and each replay adds
    the launches per kernel it recorded.  A call returns the static
    outputs, which the next replay overwrites: read them first.  On CPU
    tensors a call runs ``fn`` eagerly.  ``clock`` times the capture.

    ``stages`` holds the stage marks of ``fn`` (``serve.trace.stage``):
    on the card the timing events captured into the graph, which every
    replay records again; on the CPU the host clock around each call.
    Its ``elapsed_ms()`` is the last call's, on the card once the outputs
    have been read back."""

    def __init__(self, fn, args, clock=time.perf_counter):
        self.fn = fn
        self.clock = clock
        self.graph = None
        #: launches per kernel of one replay (name -> count); seconds of
        #: the capture; bytes of the graph's private pool
        self.launches, self.capture_s, self.pool_bytes = {}, 0.0, 0
        self.stages = StageClock(tracer, events=args[0].is_cuda)
        if args[0].is_cuda:
            self._capture(args)

    def _capture(self, args):
        dev = args[0].device
        self.inputs = tuple(a.clone() for a in args)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(*self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [k.launches for k in COUNTED_KERNELS]
        t0 = self.clock()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                reserved = torch.cuda.memory_reserved(dev)
                with self.stages:
                    self.outputs = self.fn(*self.inputs)
        finally:
            recorded = [k.launches - b for k, b in zip(COUNTED_KERNELS, before)]
            for k, b in zip(COUNTED_KERNELS, before):
                k.launches = b  # the capture launched nothing
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = self.clock() - t0
        self.launches = {k.__name__: n for k, n in zip(COUNTED_KERNELS, recorded) if n}
        self.graph = graph

    def __call__(self, *args):
        if self.graph is None:
            with self.stages:
                return self.fn(*args)
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        for k in COUNTED_KERNELS:
            k.launches += self.launches.get(k.__name__, 0)
        return self.outputs


@dataclasses.dataclass
class RetrievalService:
    coll: Collection
    csa: CSA
    ilcp: ILCPIndex
    pdl_list: PDLIndex
    sada: SadaCount
    da: torch.Tensor
    pdl_topk: PDLIndex | None = None  # serves topk and tfidf
    occ_df_threshold: float = 4.0     # paper: brute wins when occ/df < ~4
    brute_window: int | None = None   # None = size per bucket from occ stats
    _brute_windows: dict = dataclasses.field(default_factory=dict, repr=False)
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)
    #: programs built per kind: captures on the card (one per bucket and
    #: Brute-L window), cached eager programs on the CPU
    compile_counts: dict = dataclasses.field(default_factory=dict, init=False, repr=False)
    #: host-clock seconds of each build stage (suffix, csa, ilcp, pdl,
    #: pdl_topk, sada, validate)
    build_seconds: dict = dataclasses.field(default_factory=dict, repr=False)
    #: per-structure CRC32s recorded by build-time validation
    #: (``repro_torch.serve.validate``); a load path compares them with
    #: ``verify_fingerprints``
    fingerprints: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.da.device

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls, coll: Collection, block_size: int = 64, beta: float = 16.0,
        sada_variant: str = "sparse", sample_rate: int = 16,
        brute_window: int | None = None, topk_index: bool = True,
        validate: bool = True, device="cuda", mesh=None, clock=time.perf_counter,
    ):
        """Build the index stack on ``device`` (the card unless the caller
        asks for the CPU).  Queries go through the kernel wrappers, which
        run the kernels' plain versions only on CPU tensors.

        ``topk_index=False`` skips the top-k PDL, and with it ``topk`` and
        ``tfidf``: with ``beta=None`` it stores every internal node's list,
        about d entries per node on a repetitive collection, and its host
        build grows faster than n (PERF.md, section 5).  ``validate=True``
        checks every structure's invariants and stores the fingerprints
        (``repro_torch.serve.validate``): a corrupted index raises
        ``IndexIntegrityError`` here, before it can serve.

        ``mesh`` (``repro_torch.dist.sharding.make_docs_mesh``) builds the
        docs-sharded service instead: contiguous document shards, each
        with its own stack, merged exactly
        (``repro_torch.serve.sharded.ShardedRetrievalService``).  ``clock``
        times the stages (``build_seconds``)."""
        if mesh is not None:
            from repro_torch.serve.sharded import ShardedRetrievalService

            return ShardedRetrievalService.build(
                coll, mesh, block_size=block_size, beta=beta, sada_variant=sada_variant,
                sample_rate=sample_rate, brute_window=brute_window, topk_index=topk_index,
                validate=validate, device=device, clock=clock,
            )
        dev = resolve_device(device)
        seconds = {}

        def timed(name, fn, *args, **kw):
            t0 = clock()
            out = fn(*args, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds[name] = clock() - t0
            return out

        data = timed("suffix", build_suffix_data, coll, dev)
        svc = cls(
            coll=coll,
            csa=timed("csa", build_csa, data, sample_rate=sample_rate),
            ilcp=timed("ilcp", build_ilcp, data),
            pdl_list=timed("pdl", build_pdl, data, block_size=block_size, beta=beta,
                           mode="list"),
            pdl_topk=timed("pdl_topk", build_pdl, data, block_size=block_size,
                           beta=None, mode="topk") if topk_index else None,
            sada=timed("sada", build_sada, data, sada_variant),
            da=data.da,
            brute_window=brute_window,
            build_seconds=seconds,
        )
        if validate:
            svc.fingerprints.update(timed("validate", validate_service, svc))
        return svc

    # -- program cache -------------------------------------------------------

    def _compiled(self, kind: str, statics: tuple, build_fn, args: tuple) -> Program:
        """One program per (kind, statics) bucket, built (on the card:
        captured) exactly once; every later batch that pads into the bucket
        replays it."""
        key = (kind, statics)
        prog = self._cache.get(key)
        if prog is None:
            faults.fire(f"compile:{kind}")
            prog = Program(build_fn(), args)
            self._cache[key] = prog
            self.compile_counts[kind] = self.compile_counts.get(kind, 0) + 1
        return prog

    def compiled_programs(self) -> dict:
        """The live program cache, keyed (kind, statics)."""
        return dict(self._cache)

    # the program of each endpoint kind, with the index bound in: what the
    # cache builds and ``endpoint_program`` hands the audit

    def _plan_fn(self):
        return functools.partial(plan_queries, self.csa, self.sada)

    def _list_fn(self, max_df, win, max_buf):
        return functools.partial(_list_program, max_df, win, max_buf, self.csa, self.ilcp,
                                 self.pdl_list, self.da, self.sada)

    def _topk_fn(self, k, max_df, win, max_buf):
        return functools.partial(_topk_program, k, max_df, win, max_buf, self.csa,
                                 self.pdl_topk, self.sada)

    def _tfidf_fn(self, k, conjunctive, max_buf):
        return functools.partial(_tfidf_program, k, conjunctive, max_buf, self.csa,
                                 self.pdl_topk, self.sada)

    # -- batching ------------------------------------------------------------

    def _pad_batch(self, patterns):
        """Dense [B_bucket, m_bucket] pattern batch + lengths on the device
        + true size.  Every pattern passes ``normalize_patterns`` first."""
        patterns = normalize_patterns(
            patterns, sigma=self.coll.sigma, max_len=MAX_PATTERN_LEN
        )
        pats, lens = pad_patterns(patterns)
        B, m = pats.shape
        Bb, mb = _bucket_batch(B), _bucket_len(m)
        out = np.zeros((Bb, mb), np.int32)
        out[:B, :m] = pats
        lns = np.zeros(Bb, np.int32)
        lns[:B] = lens
        return as_i32(out, self.device), as_i32(lns, self.device), B

    def _pad_terms(self, queries, max_terms: int):
        """Dense [Q_bucket, max_terms, m_bucket] term batch + lengths on the
        device; at most ``max_terms`` terms of each query are used."""
        queries = [
            normalize_patterns(list(terms)[:max_terms], sigma=self.coll.sigma,
                               max_len=MAX_PATTERN_LEN)
            for terms in queries
        ]
        m = max((len(t) for terms in queries for t in terms), default=1)
        Qb, mb = _bucket_batch(len(queries)), _bucket_len(max(m, 1))
        pats = np.zeros((Qb, max_terms, mb), np.int32)
        lens = np.zeros((Qb, max_terms), np.int32)
        for qi, terms in enumerate(queries):
            for ti, t in enumerate(terms):
                pats[qi, ti, : len(t)] = t
                lens[qi, ti] = len(t)
        return as_i32(pats, self.device), as_i32(lens, self.device)

    def _knobs(self, engine: str):
        return plan_knobs(self.occ_df_threshold, engine, self.device)

    def _brute_window_for(self, kind: str, bucket_key: tuple, patterns,
                          engine: str, max_buf: int) -> int:
        """Dispatch-aware Brute-L window: the power-of-two cover of the
        largest occ among brute-assigned queries (from a plan pass of its
        own), clamped to [BRUTE_WINDOW_FLOOR, max_buf], grow-only per
        bucket.  Results do not depend on it: the executor masks the
        window against each query's occ.  Traced as ``service.window``,
        with the plan's rows per engine (``service.rows.<engine>``) and
        the window (``service.brute_window``) as counters."""
        if self.brute_window is not None:
            win = min(self.brute_window, max_buf)
        else:
            with tracer.span("service.window"):
                plan = self.plan(patterns, engine)
                occ = plan["occ"][plan["engine"] == ENGINE_BRUTE]
                needed = int(occ.max()) if occ.size else 0
                win = min(max(_pow2_ceil(needed), BRUTE_WINDOW_FLOOR), max_buf)
                key = (kind, bucket_key)
                win = max(win, self._brute_windows.get(key, 0))
                self._brute_windows[key] = win
            rows = np.bincount(plan["engine"], minlength=len(ENGINE_ROWS))
            for code, name in enumerate(ENGINE_ROWS):
                tracer.count(name, int(rows[code]))
        tracer.count("service.brute_window", win)
        return win

    def _run(self, prog, args, rows: int, outputs) -> tuple:
        """Call ``prog`` (``service.replay``: the input copies and the
        replay, which only enqueues on the card), copy the first ``rows``
        of each of ``outputs(result)`` to the host (``service.readback``,
        where the host waits for the card), then record the call's stage
        times as device spans."""
        with tracer.span("service.replay"):
            out = prog(*args)
        with tracer.span("service.readback"):
            host = tuple(x[:rows].cpu().numpy() for x in outputs(out))
        tracer.device_stages(prog.stages)
        return host

    # -- endpoints -----------------------------------------------------------

    def plan(self, patterns, engine: str = "auto"):
        """Query plan for a pattern batch: host arrays (lo, hi, occ, df,
        engine), trimmed to the true batch size."""
        with tracer.span("service.pad"):
            pats, lens, B = self._pad_batch(patterns)
            args = (pats, lens, *self._knobs(engine))
        faults.fire("plan")
        with tracer.span("service.program"):
            prog = self._compiled("plan", (tuple(pats.shape),), self._plan_fn, args)
        names = ("lo", "hi", "occ", "df", "engine")
        return dict(zip(names, self._run(prog, args, B,
                                         lambda p: [getattr(p, n) for n in names])))

    def ranges(self, patterns):
        """(lo, hi, normalized pattern lengths) per pattern, host arrays."""
        p = self.plan(patterns)
        norm = normalize_patterns(patterns, sigma=self.coll.sigma, max_len=MAX_PATTERN_LEN)
        lens = np.asarray([len(x) for x in norm], np.int32)
        return p["lo"], p["hi"], lens

    def count(self, patterns, engine: str = "auto"):
        """df per pattern (Sadakane counting).  ``engine="reference"``
        computes the same counts through the per-query path, the
        runtime's last-resort degradation.  Any other engine name is
        ignored, as the reference ignores it: df does not depend on it."""
        if engine.startswith("reference"):
            return self._ranges_dfs(patterns)[2]
        return self.plan(patterns)["df"]

    def count_ilcp(self, patterns):
        """df per pattern by ILCP counting (Fig 3), a cross-check of
        ``count``."""
        lo, hi, lens = self.ranges(patterns)
        dev = self.device
        return ilcp_count_docs_batch(self.ilcp, as_i32(lo, dev), as_i32(hi, dev),
                                     as_i32(lens, dev)).cpu().numpy()

    def list_docs_arrays(self, patterns, max_df: int = 256, engine: str = "auto",
                         max_buf: int = 4096):
        """Array-level listing endpoint: (docs int32[B, max_df] ascending,
        -1 padded, counts int32[B]) as host arrays."""
        _require_knobs(max_df=max_df)
        if not len(patterns):
            return np.zeros((0, max_df), np.int32), np.zeros(0, np.int32)
        with tracer.span("service.pad"):
            pats, lens, B = self._pad_batch(patterns)
            args = (pats, lens, *self._knobs(engine))
        win = self._brute_window_for(
            "list", (tuple(pats.shape), max_df, max_buf), patterns, engine, max_buf
        )
        faults.fire("executor:list")
        with tracer.span("service.program"):
            prog = self._compiled(
                "list", (tuple(pats.shape), max_df, win, max_buf),
                lambda: self._list_fn(max_df, win, max_buf), args,
            )
        return faults.poison("executor:list", self._run(prog, args, B, lambda out: out[:2]))

    def list_docs(self, patterns, max_df: int = 256, engine: str = "auto",
                  max_buf: int = 4096):
        """Document listing with the paper's df/occ dispatch policy;
        ``engine``: "auto" | "brute" | "ilcp" | "pdl" run the batched
        programs, "reference" (or "reference:<engine>") the per-query
        loop."""
        _require_knobs(max_df=max_df)
        if engine.startswith("reference"):
            return self._list_docs_reference(patterns, max_df, _sub_engine(engine), max_buf)
        docs, cnt = self.list_docs_arrays(patterns, max_df, engine, max_buf)
        return [docs[i, : cnt[i]].tolist() for i in range(len(cnt))]

    def _topk_max_df(self, max_buf: int) -> int:
        return min(self.coll.d + 1, max_buf)

    def _require_topk_index(self):
        if self.pdl_topk is None:
            raise ValueError("this service has no top-k PDL (pdl_topk): "
                             "topk and tfidf need one")

    def topk_arrays(self, patterns, k: int = 10, engine: str = "auto",
                    max_buf: int = 4096):
        """Array-level top-k endpoint: (docs int32[B, k] padded -1,
        tf int32[B, k]) as host arrays, ranked by (tf desc, id asc)."""
        _require_knobs(k=k, max_buf=max_buf)
        if not len(patterns):
            return np.zeros((0, k), np.int32), np.zeros((0, k), np.int32)
        self._require_topk_index()
        with tracer.span("service.pad"):
            pats, lens, B = self._pad_batch(patterns)
            args = (pats, lens, *self._knobs(engine))
        max_df = self._topk_max_df(max_buf)
        win = self._brute_window_for(
            "topk", (tuple(pats.shape), k, max_buf), patterns, engine, max_buf
        )
        faults.fire("executor:topk")
        with tracer.span("service.program"):
            prog = self._compiled(
                "topk", (tuple(pats.shape), k, max_df, win, max_buf),
                lambda: self._topk_fn(k, max_df, win, max_buf), args,
            )
        return faults.poison("executor:topk", self._run(prog, args, B, lambda out: out[:2]))

    def topk(self, patterns, k: int = 10, engine: str = "auto", max_buf: int = 4096):
        """Top-k documents by term frequency: per pattern, [(doc, tf), ...];
        ``engine`` as for ``list_docs``."""
        _require_knobs(k=k, max_buf=max_buf)
        if engine.startswith("reference"):
            return self._topk_reference(patterns, k, _sub_engine(engine), max_buf)
        docs, tfs = self.topk_arrays(patterns, k, engine, max_buf)
        return [[(int(d), int(t)) for d, t in zip(docs[i], tfs[i]) if d >= 0]
                for i in range(docs.shape[0])]

    def tfidf_arrays(self, queries, k: int = 10, conjunctive: bool = False,
                     max_terms: int = 4, max_buf: int = 2048):
        """Array-level ranked multi-term endpoint over lists of term
        patterns (at most ``max_terms`` each are used): (docs int32[Q, k]
        padded -1, scores float32[Q, k]) as host arrays."""
        Q = len(queries)
        if Q == 0:
            return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
        self._require_topk_index()
        with tracer.span("service.pad"):
            args = self._pad_terms(queries, max_terms)
        faults.fire("executor:tfidf")
        with tracer.span("service.program"):
            prog = self._compiled(
                "tfidf", (tuple(args[0].shape), k, conjunctive, max_buf),
                lambda: self._tfidf_fn(k, conjunctive, max_buf), args,
            )
        return faults.poison("executor:tfidf", self._run(prog, args, Q, lambda out: out))

    def tfidf(self, queries, k: int = 10, conjunctive: bool = False,
              max_terms: int = 4, max_buf: int = 2048, engine: str = "auto"):
        """Ranked multi-term retrieval: per query, [(doc, score), ...];
        ``engine="reference"`` takes each query's term ranges per query."""
        if engine.startswith("reference"):
            return self._tfidf_reference(queries, k, conjunctive, max_terms, max_buf)
        docs, scores = self.tfidf_arrays(queries, k, conjunctive, max_terms, max_buf)
        return [[(int(d), float(s)) for d, s in zip(docs[i], scores[i]) if d >= 0]
                for i in range(docs.shape[0])]

    # -- reference per-query path (parity oracle) ----------------------------

    def _dispatch(self, occ: int, df: int, engine: str) -> str:
        if engine != "auto":
            return engine
        return "brute" if occ < self.occ_df_threshold * max(df, 1) else "pdl"

    def _ranges_dfs(self, patterns):
        """(lo, hi, df) host arrays of a pattern list, through the same
        input gate as the batched path: one backward-search launch."""
        patterns = normalize_patterns(patterns, sigma=self.coll.sigma, max_len=MAX_PATTERN_LEN)
        # at least one column, so a batch of empty patterns still searches
        pats, lens = pad_patterns(patterns, max((len(p) for p in patterns), default=0) or 1)
        pats, lens = as_i32(pats, self.device), as_i32(lens, self.device)
        lo, hi = csa_search_batch(self.csa, pats, lens)
        # as in the planner: zero-length patterns are empty, not the full range
        hi = torch.where(lens > 0, hi, lo)
        dfs = sada_count_batch(self.sada, lo, hi)
        return lo.cpu().numpy(), hi.cpu().numpy(), dfs.cpu().numpy()

    def _list_docs_reference(self, patterns, max_df, engine, max_buf):
        if not len(patterns):
            return []
        lo, hi, dfs = self._ranges_dfs(patterns)
        out = []
        for qi in range(len(lo)):
            a, b = int(lo[qi]), int(hi[qi])
            if a >= b:
                out.append([])
                continue
            eng = self._dispatch(b - a, int(dfs[qi]), engine)
            if eng == "brute":
                # window min(occ, max_buf) covers the positions the batched
                # executor's window covers (validity-masked)
                docs, cnt, _ = brute_list_csa(self.csa, a, b, min(b - a, max_buf), max_df)
            elif eng == "ilcp":
                docs, cnt = ilcp_list_docs_da(self.ilcp, self.da, a, b, max_df)
            else:
                docs, cnt = pdl_list_docs(self.pdl_list, self.csa, a, b, max_df,
                                          max_buf=max_buf)
            out.append(sorted(docs[: int(cnt)].tolist()))
        return out

    def _topk_reference(self, patterns, k, engine, max_buf):
        if not len(patterns):
            return []
        self._require_topk_index()
        lo, hi, dfs = self._ranges_dfs(patterns)
        max_df = self._topk_max_df(max_buf)
        out = []
        for qi in range(len(lo)):
            a, b = int(lo[qi]), int(hi[qi])
            if a >= b:
                out.append([])
                continue
            if self._dispatch(b - a, int(dfs[qi]), engine) == "brute":
                docs, tfs = brute_topk(*brute_list_csa(self.csa, a, b, min(b - a, max_buf),
                                                       max_df), k)
            else:
                docs, tfs = pdl_topk(self.pdl_topk, self.csa, a, b, k, max_buf=max_buf)
            out.append([(int(d), int(t)) for d, t in zip(docs.tolist(), tfs.tolist())
                        if d >= 0])
        return out

    def _tfidf_reference(self, queries, k, conjunctive, max_terms, max_buf):
        Q = len(queries)
        if Q == 0:
            return []
        self._require_topk_index()
        ranges = np.zeros((Q, max_terms, 2), np.int32)
        valid = np.zeros((Q, max_terms), bool)
        for qi, terms in enumerate(queries):
            if not len(terms):
                continue
            lo, hi, _ = self._ranges_dfs(list(terms)[:max_terms])
            for ti in range(len(lo)):
                ranges[qi, ti] = (lo[ti], hi[ti])
                valid[qi, ti] = True
        docs, scores = tfidf_topk_batch(
            self.pdl_topk, self.csa, self.sada, as_i32(ranges, self.device),
            torch.as_tensor(valid, device=self.device), k, conjunctive, max_buf=max_buf,
        )
        return [[(int(d), float(s)) for d, s in zip(docs[qi].tolist(), scores[qi].tolist())
                 if d >= 0] for qi in range(Q)]

    # -- introspection --------------------------------------------------------

    #: endpoint kinds with a program per shape bucket (``count`` rides the
    #: ``plan`` program)
    ENDPOINT_KINDS = ("plan", "list", "topk", "tfidf")

    def endpoint_program(self, kind: str, *, max_df: int = 64, k: int = 10,
                         max_buf: int = 512, conjunctive: bool = False):
        """The program the cache would build for ``kind``, from the same
        builders, and its example arguments: ``(fn, args_builder)``, where
        ``args_builder(B, m)`` makes a padded [B, m-bucket] batch on the
        service's device (``tfidf``: [B, 2, m-bucket] terms) with the
        planner's ``auto`` knobs.  ``list`` and ``topk`` take the pinned
        Brute-L window ``min(BRUTE_WINDOW_FLOOR, max_buf)``, as the
        reference's audit does; the extra plan pass of an automatic window
        runs outside the program.  ``repro_torch.analysis`` audits these."""
        win = min(BRUTE_WINDOW_FLOOR, max_buf)
        if kind == "plan":
            fn = self._plan_fn()
        elif kind == "list":
            fn = self._list_fn(max_df, win, max_buf)
        elif kind == "topk":
            self._require_topk_index()
            fn = self._topk_fn(k, self._topk_max_df(max_buf), win, max_buf)
        elif kind == "tfidf":
            self._require_topk_index()
            fn = self._tfidf_fn(k, conjunctive, max_buf)

            def terms(B, m):
                return (torch.zeros((B, 2, _bucket_len(m)), dtype=IDX, device=self.device),
                        torch.ones((B, 2), dtype=IDX, device=self.device))

            return fn, terms
        else:
            raise ValueError(f"unknown endpoint kind {kind!r}")
        return fn, self._audit_batch

    def _audit_batch(self, B: int, m: int):
        dev = self.device
        return (torch.zeros((B, _bucket_len(m)), dtype=IDX, device=dev),
                torch.ones(B, dtype=IDX, device=dev), *self._knobs("auto"))

    def trace_endpoint(self, kind: str, B: int = 8, m: int = 8, **kw):
        """One run of ``kind``'s program at the (B, m) bucket, recorded
        (``repro_torch.analysis.programs.ProgramTrace``); ``kw`` goes to
        ``endpoint_program``."""
        from repro_torch.analysis.programs import trace_program

        fn, args = self.endpoint_program(kind, **kw)
        return trace_program(kind, (B, m), fn, args(_bucket_batch(B), m))

    def space_report(self) -> dict:
        """Bits-per-character accounting in the paper's units, keyed in the
        reference's order (the top-k PDL's entry only where the service
        has one)."""
        n = self.coll.n
        report = {
            "n": n,
            "d": self.coll.d,
            "csa_rlcsa_bpc": self.csa.modeled_bits_rlcsa() / n,
            "ilcp_listing_bpc": self.ilcp.modeled_bits_listing() / n,
            "ilcp_counting_bpc": self.ilcp.modeled_bits_counting() / n,
            "pdl_list_bpc": self.pdl_list.modeled_bits() / n,
        }
        if self.pdl_topk is not None:
            report["pdl_topk_bpc"] = self.pdl_topk.modeled_bits() / n
        report.update(sada_bpc=self.sada.modeled_bits() / n, bwt_runs=self.csa.bwt_runs,
                      ilcp_runs=self.ilcp.nruns)
        return report
