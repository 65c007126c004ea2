"""Batch pipelines (counterpart of ``repro.data.pipelines``), numpy only.

LM: synthetic token streams (optionally sliced from a document
collection's symbol stream, tying the paper's corpora to LM training),
with a double-buffered host prefetcher.  RecSys: Criteo-like click
batches with skewed categorical draws, or SASRec sequence batches.  For a
given seed (and text) ``lm_batches`` and ``recsys_batches`` yield the
reference's arrays.  The GNN generators wait for their model (ROADMAP
A12.5).
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
