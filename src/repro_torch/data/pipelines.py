"""Batch pipelines (counterpart of ``repro.data.pipelines``), numpy only.

LM: synthetic token streams (optionally sliced from a document
collection's symbol stream, tying the paper's corpora to LM training),
with a double-buffered host prefetcher.  RecSys: Criteo-like click
batches with skewed categorical draws, or SASRec sequence batches.  GNN:
random graphs at the registry's shapes, CSR adjacency and a layered
neighbor sampler (fanout 15-10).  For a given seed (and text) every
generator gives the reference's arrays.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0, text=None):
    """Infinite token-batch generator of ``{"tokens", "labels"}`` int32
    [batch, seq] (the same array twice: ``forward_train`` shifts).  With
    ``text`` (an int array, e.g. a Collection's symbol stream), batches are
    sliced from the corpus; otherwise Zipf-ish random tokens."""
    rng = np.random.default_rng(seed)
    if text is not None:
        text = np.asarray(text) % vocab
    while True:
        if text is not None and len(text) > seq + 1:
            starts = rng.integers(0, len(text) - seq - 1, batch)
            tokens = np.stack([text[s: s + seq] for s in starts])
        else:
            tokens = rng.zipf(1.3, (batch, seq)).clip(0, vocab - 1)
        yield {"tokens": tokens.astype(np.int32), "labels": tokens.astype(np.int32)}


class Prefetcher:
    """Double-buffered host-side prefetch: a daemon thread assembles the
    next ``depth`` items while the device runs the step."""

    def __init__(self, it, depth: int = 2):
        self.q = queue.Queue(maxsize=depth)
        self.it = it
        self.done = False
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()

    def _fill(self):
        for item in self.it:
            self.q.put(item)
            if self.done:
                return

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self.done = True


def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_graphs: int = 1,
                 seed: int = 0) -> dict:
    """A random graph batch: ``node_feat`` f32 [N, d_feat] normal,
    ``edge_index`` int32 [2, E] (src, dst) uniform over the nodes,
    ``edge_vec`` f32 [E, 3] normal x 2, ``graph_id`` int32 [N] sorted
    uniform graph ids, ``energy`` f32 [n_graphs] normal targets."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    return {
        "node_feat": rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
        "edge_index": np.stack([src, dst]).astype(np.int32),
        "edge_vec": (rng.standard_normal((n_edges, 3)) * 2).astype(np.float32),
        "graph_id": np.sort(rng.integers(0, n_graphs, n_nodes)).astype(np.int32),
        "energy": rng.standard_normal(n_graphs).astype(np.float32),
    }


def build_csr(n_nodes: int, edge_index: np.ndarray):
    """CSR adjacency by destination for sampling: (indptr int64 [N + 1],
    neighbors [E], each destination's sources in edge order)."""
    src, dst = edge_index
    order = np.argsort(dst, kind="stable")
    neighbors = src[order]
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return indptr, neighbors


def neighbor_sample(indptr, neighbors, seeds: np.ndarray, fanouts=(15, 10), seed: int = 0):
    """Layered fanout sampling (GraphSAGE-style): (nodes int64 [n], the
    sampled subgraph's edge_index int32 [2, E] in local ids).  Every
    frontier node draws ``fanout`` in-neighbors with replacement (an
    isolated node draws self-loops, so zero-length edges can occur); the
    next frontier is the nodes first seen in this layer.  A layer adds
    ``fanout`` edges per frontier node."""
    rng = np.random.default_rng(seed)
    id_of = {int(v): i for i, v in enumerate(np.asarray(seeds))}
    all_nodes = [int(v) for v in np.asarray(seeds)]
    edges_src, edges_dst = [], []
    frontier = list(all_nodes)
    for fanout in fanouts:
        discovered = []
        for v in frontier:
            lo, hi = int(indptr[v]), int(indptr[v + 1])
            if hi > lo:
                picks = neighbors[rng.integers(lo, hi, fanout)]
            else:
                picks = np.full(fanout, v)  # isolated: self-loops
            for u in picks:
                u = int(u)
                if u not in id_of:
                    id_of[u] = len(all_nodes)
                    all_nodes.append(u)
                    discovered.append(u)
                edges_src.append(id_of[u])
                edges_dst.append(id_of[v])
        frontier = discovered
    edge_index = np.stack([np.asarray(edges_src), np.asarray(edges_dst)]).astype(np.int32)
    return np.asarray(all_nodes, dtype=np.int64), edge_index


def recsys_batches(vocab_sizes, batch: int, n_dense: int = 0, seq_len: int = 0,
                   n_items: int = 0, seed: int = 0):
    """Infinite generator of Criteo-like batches: ``sparse`` int32
    [batch, F] per-field local ids (Zipf-skewed, field f's clipped into
    [0, vocab_sizes[f])), ``label`` f32 [batch] clicks with about 25%
    positives and, with ``n_dense``, ``dense`` f32 [batch, n_dense] normal
    features.  With ``seq_len`` (and ``n_items``) SASRec batches instead:
    ``item_seq``, ``pos_items`` (Zipf, clipped into [1, n_items - 1]) and
    ``neg_items`` (uniform in [1, n_items)), int32 [batch, seq_len].  Every
    id lies in its table."""
    rng = np.random.default_rng(seed)
    while True:
        if seq_len:
            seq = rng.zipf(1.2, (batch, seq_len)).clip(1, n_items - 1)
            pos = rng.zipf(1.2, (batch, seq_len)).clip(1, n_items - 1)
            neg = rng.integers(1, n_items, (batch, seq_len))
            yield {
                "item_seq": seq.astype(np.int32),
                "pos_items": pos.astype(np.int32),
                "neg_items": neg.astype(np.int32),
            }
            continue
        sparse = np.stack([rng.zipf(1.2, batch).clip(1, v) - 1 for v in vocab_sizes], axis=1)
        out = {
            "sparse": sparse.astype(np.int32),
            "label": (rng.random(batch) < 0.25).astype(np.float32),
        }
        if n_dense:
            out["dense"] = rng.standard_normal((batch, n_dense)).astype(np.float32)
        yield out
