"""Closed-loop clients over pattern pools, driven by a workload file.

Each client sends its next request as soon as its answer arrives.  Every
request's kind is drawn from the workload's ``kinds`` weights; its
patterns are one uniform draw from each pool that ``terms`` names, in
order (``list``, ``topk`` and ``count`` take the first term only).  A
request's key names its payload (pool indices), so the reference answers
each distinct payload once."""

from __future__ import annotations

import numpy as np


class Clients:
    def __init__(self, workload: dict, pools: dict, seed: int):
        self.pools = [pools[name] for name in workload["terms"]]
        self.rng = np.random.default_rng(seed)
        kinds = workload["kinds"]
        self.kinds = sorted(kinds)
        w = np.asarray([kinds[k] for k in self.kinds], np.float64)
        self.weights = w / w.sum()
        self.count = int(workload["clients"])

    def draw(self):
        """(kind, key, payload) of one request."""
        kind = self.kinds[int(self.rng.choice(len(self.kinds), p=self.weights))] \
            if len(self.kinds) > 1 else self.kinds[0]
        if kind == "tfidf":
            key = tuple(int(self.rng.integers(0, len(p))) for p in self.pools)
            return kind, key, [p[i] for p, i in zip(self.pools, key)]
        i = int(self.rng.integers(0, len(self.pools[0])))
        return kind, i, self.pools[0][i]
