"""Pattern pools: the paper's Section 6.1.2 generator, scored on the
benchmark's own suffix array.

Random substrings of one length are extracted and deduplicated.  Ranked by
``occ_df``, the ``keep`` with the largest occ/df are the pool (a frozen
copy of ``repro_torch.data.collections.random_substring_patterns``, with
the ranges taken from ``port_bench.reference``); ranked by ``df``, the
``keep`` held by the fewest documents (rare terms, whose idf weight is not
zero)."""

from __future__ import annotations

import numpy as np


def pattern_pool(ref, n_extract: int, length: int, keep: int, seed: int,
                 rank: str = "occ_df") -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    text, n = ref.text, len(ref.text)
    cands = set()
    for _ in range(n_extract):
        p = int(rng.integers(0, max(1, n - length)))
        sub = text[p:p + length]
        if (sub == 0).any():
            continue
        cands.add(tuple(int(x) for x in sub))
    scored = []
    for c in sorted(cands):
        pat = np.asarray(c, dtype=np.int32)
        _, _, occ, df = ref.stats(pat)
        if occ:
            scored.append((occ / df if rank == "occ_df" else -df, pat))
    if rank not in ("occ_df", "df"):
        raise ValueError(f"unknown pool ranking {rank!r}")
    scored.sort(key=lambda t: -t[0])
    return [pat for _, pat in scored[:keep]]
