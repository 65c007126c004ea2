"""Batch pipelines (counterpart of ``repro.data.pipelines``), numpy only.

LM: synthetic token streams (optionally sliced from a document
collection's symbol stream, tying the paper's corpora to LM training),
with a double-buffered host prefetcher.  For a given seed and text
``lm_batches`` yields the reference's arrays.  The GNN and recsys
generators wait for their models (ROADMAP A12.4, A12.5).
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
