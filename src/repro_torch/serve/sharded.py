"""Docs-sharded retrieval: per-shard index stacks and an exact cross-shard
merge (counterpart of ``repro.serve.sharded``).

* **Partitioning.**  Documents are split into contiguous shards
  (``repro_torch.dist.sharding.doc_shard_bounds``); each shard is a full
  flat ``RetrievalService`` over its sub-collection
  (``core.suffix.subcollection``, the global sigma kept).  Every document
  ends in its own terminator and patterns never hold it, so a pattern's
  matches in a shard's documents are its matches in the shard's text:
  per-shard occ, df and document sets add up (disjoint union) to the
  global answer.

* **Execution.**  ONE program per endpoint and shape bucket, in the same
  bucketed cache as the flat service (``retrieval.Program``: a CUDA graph
  on the card).  Inside it every shard's flat program runs in turn (the
  planner, ``_list_program``, ``_topk_program``, the tf-idf stages), so
  each kernel launches once per shard per replay, and the merge follows
  as plain tensor operations on the device.  Nothing in a program waits
  on the host.

* **Merge algebra.**
  - counting: global df and occ are sums of the per-shard counts;
  - listing: shard-local ids offset by the shard's first document,
    concatenated and sorted (shards are document-disjoint: no dedup),
    cut to ``max_df``;
  - top-k: the shards' top-k rows merged by (tf desc, id asc); a
    document's tf is local to its shard, so the union of the shards'
    top-k holds the global top-k;
  - tf-idf: a first stage sums the shards' Sada df per term; each shard
    then scores its candidates with the global df and document count
    (``tfidf_topk_batch(dfs_batch=..., n_docs=...)``), so a document's
    float is the flat service's; the merge ranks by (score desc, id asc).

Every shard's stack lives on the docs mesh's one device (see
``repro_torch.dist.sharding``).  ``engine="reference[:<engine>]"`` runs
the shards' per-query oracles and merges on the host.  The fault sites
are the flat service's, in its order.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.common import BIG, IDX, as_i32, lexsort_rows, resolve_device
from repro_torch.core.sada import sada_count_batch
from repro_torch.core.suffix import Collection, subcollection
from repro_torch.core.tfidf import rank_topk_scores, term_ranges_batch, tfidf_topk_batch
from repro_torch.dist.sharding import DocsMesh, doc_shard_bounds, docs_mesh_size
from repro_torch.serve import faults
from repro_torch.serve.planner import ENGINE_BRUTE, plan_queries
from repro_torch.serve.retrieval import (
    BRUTE_WINDOW_FLOOR,
    RetrievalService,
    _list_program,
    _pow2_ceil,
    _require_knobs,
    _sorted_rows,
    _sub_engine,
    _topk_program,
)
from repro_torch.serve.validate import validate_sharded_service


def _offset(docs, base: int):
    """Shard-local document ids to global ones; -1 padding stays."""
    return torch.where(docs >= 0, docs + base, -1)


def _by_query(stacked):
    """[S, B, W] per-shard rows -> [B, S * W], shard-major in each row."""
    S, B, W = stacked.shape
    return stacked.transpose(0, 1).reshape(B, S * W)


# ---------------------------------------------------------------------------
# Sharded programs: one per endpoint and bucket, every shard inside it
# ---------------------------------------------------------------------------


def _sharded_plan_program(shards, patterns, lengths, threshold, forced):
    """Per-shard plans and the summed global occ and df: (lo [S, B],
    hi [S, B], engine [S, B], occ [B], df [B]).  Ranges and engine choices
    are shard-local (each shard dispatches on its own occ/df)."""
    plans = [plan_queries(sh.csa, sh.sada, patterns, lengths, threshold, forced)
             for sh in shards]

    def stack(name):
        return torch.stack([getattr(p, name) for p in plans])

    return (stack("lo"), stack("hi"), stack("engine"), stack("occ").sum(0, dtype=IDX),
            stack("df").sum(0, dtype=IDX))


def _sharded_list_program(max_df, brute_win, max_buf, shards, doc_bases,
                          patterns, lengths, threshold, forced):
    """Listing: per-shard engines, offset ids, concatenate, sort, cut."""
    docs, cnt = [], []
    for sh, base in zip(shards, doc_bases):
        d, c, _ = _list_program(max_df, brute_win, max_buf, sh.csa, sh.ilcp, sh.pdl_list,
                                sh.da, sh.sada, patterns, lengths, threshold, forced)
        docs.append(_offset(d, base))
        cnt.append(c)
    total = torch.stack(cnt).sum(0, dtype=IDX)
    merged = _sorted_rows(_by_query(torch.stack(docs)))[:, :max_df]
    return merged, torch.clamp(total, max=max_df).to(IDX)


def _sharded_topk_program(k, max_df, brute_win, max_buf, shards, doc_bases,
                          patterns, lengths, threshold, forced):
    """Top-k: per-shard top-k rows merged by (tf desc, id asc)."""
    docs, tfs = [], []
    for sh, base in zip(shards, doc_bases):
        d, t, _ = _topk_program(k, max_df, brute_win, max_buf, sh.csa, sh.pdl_topk, sh.sada,
                                patterns, lengths, threshold, forced)
        docs.append(_offset(d, base))
        tfs.append(t)
    d2, t2 = _by_query(torch.stack(docs)), _by_query(torch.stack(tfs))
    ok = d2 >= 0
    dkey = torch.where(ok, d2, BIG)
    top = lexsort_rows(torch.where(ok, -t2, BIG), dkey)[:, :k]
    top_docs = torch.gather(dkey, 1, top)
    good = top_docs < BIG
    return (torch.where(good, top_docs, -1).to(IDX),
            torch.where(good, torch.gather(t2, 1, top), 0).to(IDX))


def _sharded_tfidf_program(n_docs, k, conjunctive, max_buf, shards, doc_bases,
                           patterns, lengths):
    """tf-idf in two stages: the summed global df per term, then each
    shard scores with the global weights; merged by (score desc, id asc)."""
    Q, T, _ = patterns.shape
    ranges, dfs = [], []
    for sh in shards:
        r, valid = term_ranges_batch(sh.csa, patterns, lengths)
        lo = r[..., 0].reshape(-1).contiguous()
        hi = r[..., 1].reshape(-1).contiguous()
        ranges.append(r)
        dfs.append(sada_count_batch(sh.sada, lo, hi).reshape(Q, T))
    g_dfs = torch.stack(dfs).sum(0, dtype=IDX)
    docs, scores = [], []
    for sh, base, r in zip(shards, doc_bases, ranges):
        d, s = tfidf_topk_batch(sh.pdl_topk, sh.csa, sh.sada, r, valid, k, conjunctive,
                                max_buf=max_buf, dfs_batch=g_dfs, n_docs=n_docs)
        docs.append(_offset(d, base))
        scores.append(s)
    d2 = _by_query(torch.stack(docs))
    ok = d2 >= 0
    return rank_topk_scores(torch.where(ok, d2, BIG), _by_query(torch.stack(scores)), ok, k)


# ---------------------------------------------------------------------------
# Service
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedRetrievalService:
    """Docs-sharded drop-in for ``RetrievalService``: the same endpoints
    (``plan``, ``count``, ``list_docs[_arrays]``, ``topk[_arrays]``,
    ``tfidf[_arrays]``, with ``engine="reference[:<engine>]"``), so
    ``ServeRuntime`` runs over it unchanged."""

    coll: Collection                  # the global collection
    mesh: DocsMesh
    shards: list                      # per-shard RetrievalService stacks
    doc_bases: np.ndarray             # int32[S]: each shard's first global doc id
    occ_df_threshold: float = 4.0
    brute_window: int | None = None
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)
    _brute_windows: dict = dataclasses.field(default_factory=dict, repr=False)
    #: programs built per kind (captures on the card), as the flat service's
    compile_counts: dict = dataclasses.field(default_factory=dict, init=False, repr=False)
    #: host-clock seconds of each shard's build (``shard{s}``) and of
    #: ``validate``
    build_seconds: dict = dataclasses.field(default_factory=dict, repr=False)
    #: per-shard CRC32s keyed ``shard{s}:{structure}``
    fingerprints: dict = dataclasses.field(default_factory=dict, repr=False)

    # the flat service's bucketing, program cache and planner knobs: they
    # read only ``coll``, ``device``, ``occ_df_threshold`` and the cache
    _compiled = RetrievalService._compiled
    compiled_programs = RetrievalService.compiled_programs
    _pad_batch = RetrievalService._pad_batch
    _pad_terms = RetrievalService._pad_terms
    _knobs = RetrievalService._knobs
    # and its audit surface, over the sharded program builders below
    ENDPOINT_KINDS = RetrievalService.ENDPOINT_KINDS
    endpoint_program = RetrievalService.endpoint_program
    _audit_batch = RetrievalService._audit_batch
    trace_endpoint = RetrievalService.trace_endpoint

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls, coll: Collection, mesh: DocsMesh, block_size: int = 64, beta: float = 16.0,
        sada_variant: str = "sparse", sample_rate: int = 16,
        brute_window: int | None = None, topk_index: bool = True,
        validate: bool = True, device=None, clock=time.perf_counter,
    ):
        """One flat ``RetrievalService`` per contiguous document shard, all
        on the mesh's device (``device``, where given, must be that one),
        then ``validate_sharded_service``; ``clock`` times them."""
        want = mesh.device if device is None else resolve_device(device)
        if want.type != mesh.device.type or (
                None not in (want.index, mesh.device.index) and want.index != mesh.device.index):
            raise ValueError(f"device {device!r} is not the docs mesh's {mesh.device}")
        bounds = doc_shard_bounds(coll.d, docs_mesh_size(mesh))
        shards, seconds = [], {}
        for s, (dlo, dhi) in enumerate(bounds):
            t0 = clock()
            shards.append(RetrievalService.build(
                subcollection(coll, dlo, dhi), block_size=block_size, beta=beta,
                sada_variant=sada_variant, sample_rate=sample_rate,
                brute_window=brute_window, topk_index=topk_index, validate=False,
                device=mesh.device, clock=clock,
            ))
            seconds[f"shard{s}"] = clock() - t0
        svc = cls(coll=coll, mesh=mesh, shards=shards,
                  doc_bases=np.asarray([b[0] for b in bounds], np.int32),
                  brute_window=brute_window, build_seconds=seconds)
        if validate:
            t0 = clock()
            svc.fingerprints.update(validate_sharded_service(svc))
            seconds["validate"] = clock() - t0
        return svc

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_doc_range(self, s: int) -> tuple[int, int]:
        lo = int(self.doc_bases[s])
        hi = int(self.doc_bases[s + 1]) if s + 1 < self.n_shards else self.coll.d
        return lo, hi

    def _bases(self) -> tuple:
        return tuple(int(b) for b in self.doc_bases)

    def _brute_window_for(self, kind, bucket_key, patterns, engine, max_buf):
        """One Brute-L window for every shard, from the largest
        brute-assigned per-shard occ (grow-only, as in the flat cache)."""
        if self.brute_window is not None:
            return min(self.brute_window, max_buf)
        plan = self.plan(patterns, engine)
        occ_sb = plan["hi"] - plan["lo"]                 # [S, B] shard-local
        brute = occ_sb[plan["engine_shard"] == ENGINE_BRUTE]
        needed = int(brute.max()) if brute.size else 0
        win = min(max(_pow2_ceil(needed), BRUTE_WINDOW_FLOOR), max_buf)
        key = (kind, bucket_key)
        win = max(win, self._brute_windows.get(key, 0))
        self._brute_windows[key] = win
        return win

    def _require_topk_index(self):
        for sh in self.shards:
            sh._require_topk_index()

    # the sharded program of each endpoint kind (``RetrievalService._plan_fn``
    # and its siblings' counterparts)

    def _plan_fn(self):
        return functools.partial(_sharded_plan_program, self.shards)

    def _list_fn(self, max_df, win, max_buf):
        return functools.partial(_sharded_list_program, max_df, win, max_buf, self.shards,
                                 self._bases())

    def _topk_fn(self, k, max_df, win, max_buf):
        return functools.partial(_sharded_topk_program, k, max_df, win, max_buf, self.shards,
                                 self._bases())

    def _tfidf_fn(self, k, conjunctive, max_buf):
        return functools.partial(_sharded_tfidf_program, self.coll.d, k, conjunctive, max_buf,
                                 self.shards, self._bases())

    # -- endpoints -----------------------------------------------------------

    def plan(self, patterns, engine: str = "auto"):
        """Sharded query plan: global ``occ`` and ``df`` [B] (summed), and
        shard-local ``lo``, ``hi`` and ``engine_shard`` [S, B], host
        arrays trimmed to the true batch size."""
        pats, lens, B = self._pad_batch(patterns)
        args = (pats, lens, *self._knobs(engine))
        faults.fire("plan")
        prog = self._compiled("plan", (tuple(pats.shape),), self._plan_fn, args)
        lo, hi, eng, occ, df = (x.cpu().numpy() for x in prog(*args))
        return {"lo": lo[:, :B], "hi": hi[:, :B], "engine_shard": eng[:, :B],
                "occ": occ[:B], "df": df[:B]}

    def count(self, patterns, engine: str = "auto"):
        """Global df per pattern; ``engine="reference"`` sums the shards'
        per-query counts, and any other engine name is ignored."""
        if engine.startswith("reference"):
            return sum(np.asarray(sh._ranges_dfs(patterns)[2], np.int64).astype(np.int32)
                       for sh in self.shards)
        return self.plan(patterns)["df"]

    def list_docs_arrays(self, patterns, max_df: int = 256, engine: str = "auto",
                         max_buf: int = 4096):
        _require_knobs(max_df=max_df)
        if not len(patterns):
            return np.zeros((0, max_df), np.int32), np.zeros(0, np.int32)
        pats, lens, B = self._pad_batch(patterns)
        win = self._brute_window_for(
            "list", (tuple(pats.shape), max_df, max_buf), patterns, engine, max_buf
        )
        args = (pats, lens, *self._knobs(engine))
        faults.fire("executor:list")
        prog = self._compiled(
            "list", (tuple(pats.shape), max_df, win, max_buf),
            lambda: self._list_fn(max_df, win, max_buf), args,
        )
        docs, cnt = prog(*args)
        return faults.poison("executor:list", (docs[:B].cpu().numpy(), cnt[:B].cpu().numpy()))

    def list_docs(self, patterns, max_df: int = 256, engine: str = "auto",
                  max_buf: int = 4096):
        _require_knobs(max_df=max_df)
        if engine.startswith("reference"):
            return self._list_docs_reference(patterns, max_df, _sub_engine(engine), max_buf)
        docs, cnt = self.list_docs_arrays(patterns, max_df, engine, max_buf)
        return [docs[i, : cnt[i]].tolist() for i in range(len(cnt))]

    def _topk_max_df(self, max_buf: int) -> int:
        # a shard's row holds at most its own documents + 1
        return min(max(sh.coll.d for sh in self.shards) + 1, max_buf)

    def topk_arrays(self, patterns, k: int = 10, engine: str = "auto", max_buf: int = 4096):
        _require_knobs(k=k, max_buf=max_buf)
        if not len(patterns):
            return np.zeros((0, k), np.int32), np.zeros((0, k), np.int32)
        self._require_topk_index()
        pats, lens, B = self._pad_batch(patterns)
        max_df = self._topk_max_df(max_buf)
        win = self._brute_window_for(
            "topk", (tuple(pats.shape), k, max_buf), patterns, engine, max_buf
        )
        args = (pats, lens, *self._knobs(engine))
        faults.fire("executor:topk")
        prog = self._compiled(
            "topk", (tuple(pats.shape), k, max_df, win, max_buf),
            lambda: self._topk_fn(k, max_df, win, max_buf), args,
        )
        docs, tfs = prog(*args)
        return faults.poison("executor:topk", (docs[:B].cpu().numpy(), tfs[:B].cpu().numpy()))

    def topk(self, patterns, k: int = 10, engine: str = "auto", max_buf: int = 4096):
        _require_knobs(k=k, max_buf=max_buf)
        if engine.startswith("reference"):
            return self._topk_reference(patterns, k, _sub_engine(engine), max_buf)
        docs, tfs = self.topk_arrays(patterns, k, engine, max_buf)
        return [[(int(d), int(t)) for d, t in zip(docs[i], tfs[i]) if d >= 0]
                for i in range(docs.shape[0])]

    def tfidf_arrays(self, queries, k: int = 10, conjunctive: bool = False,
                     max_terms: int = 4, max_buf: int = 2048):
        Q = len(queries)
        if Q == 0:
            return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
        self._require_topk_index()
        args = self._pad_terms(queries, max_terms)
        faults.fire("executor:tfidf")
        prog = self._compiled(
            "tfidf", (tuple(args[0].shape), k, conjunctive, max_buf),
            lambda: self._tfidf_fn(k, conjunctive, max_buf), args,
        )
        docs, scores = prog(*args)
        return faults.poison("executor:tfidf",
                             (docs[:Q].cpu().numpy(), scores[:Q].cpu().numpy()))

    def tfidf(self, queries, k: int = 10, conjunctive: bool = False,
              max_terms: int = 4, max_buf: int = 2048, engine: str = "auto"):
        if engine.startswith("reference"):
            return self._tfidf_reference(queries, k, conjunctive, max_terms, max_buf)
        docs, scores = self.tfidf_arrays(queries, k, conjunctive, max_terms, max_buf)
        return [[(int(d), float(s)) for d, s in zip(docs[i], scores[i]) if d >= 0]
                for i in range(docs.shape[0])]

    # -- reference path: per-shard per-query oracles, merged on the host -----

    def _list_docs_reference(self, patterns, max_df, engine, max_buf):
        if not len(patterns):
            return []
        per = [sh._list_docs_reference(patterns, max_df, engine, max_buf)
               for sh in self.shards]
        return [sorted(int(d) + int(self.doc_bases[s]) for s, rows in enumerate(per)
                       for d in rows[qi])[:max_df]
                for qi in range(len(per[0]))]

    def _topk_reference(self, patterns, k, engine, max_buf):
        if not len(patterns):
            return []
        per = [sh._topk_reference(patterns, k, engine, max_buf) for sh in self.shards]
        out = []
        for qi in range(len(per[0])):
            pool = [(int(d) + int(self.doc_bases[s]), int(t))
                    for s, rows in enumerate(per) for d, t in rows[qi]]
            pool.sort(key=lambda dt: (-dt[1], dt[0]))
            out.append(pool[:k])
        return out

    def _tfidf_reference(self, queries, k, conjunctive, max_terms, max_buf):
        """Per-shard scoring with the global df and document count (the
        floats the sharded program gives), ranked on the host."""
        Q = len(queries)
        if Q == 0:
            return []
        self._require_topk_index()
        ranges = np.zeros((self.n_shards, Q, max_terms, 2), np.int32)
        valid = np.zeros((Q, max_terms), bool)
        dfs = np.zeros((Q, max_terms), np.int64)
        for s, sh in enumerate(self.shards):
            for qi, terms in enumerate(queries):
                if not len(terms):
                    continue
                lo, hi, df = sh._ranges_dfs(list(terms)[:max_terms])
                for ti in range(len(lo)):
                    ranges[s, qi, ti] = (lo[ti], hi[ti])
                    valid[qi, ti] = True
                    dfs[qi, ti] += int(df[ti])
        dev = self.device
        pools = [[] for _ in range(Q)]
        for s, sh in enumerate(self.shards):
            docs, scores = tfidf_topk_batch(
                sh.pdl_topk, sh.csa, sh.sada, as_i32(ranges[s], dev),
                torch.as_tensor(valid, device=dev), k, conjunctive, max_buf=max_buf,
                dfs_batch=as_i32(dfs, dev), n_docs=self.coll.d,
            )
            for qi in range(Q):
                pools[qi] += [(int(d) + int(self.doc_bases[s]), float(w))
                              for d, w in zip(docs[qi].tolist(), scores[qi].tolist()) if d >= 0]
        for pool in pools:
            pool.sort(key=lambda dw: (-dw[1], dw[0]))
        return [pool[:k] for pool in pools]

    # -- introspection --------------------------------------------------------

    def space_report(self) -> dict:
        return {"n": self.coll.n, "d": self.coll.d, "n_shards": self.n_shards,
                "shards": [sh.space_report() for sh in self.shards]}
