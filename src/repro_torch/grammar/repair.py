"""Re-Pair grammar compression (Larsson & Moffat 2000).

Used by PDL (Section 4) to compress precomputed document lists: frequent
pairs of symbols are replaced by fresh nonterminals until no pair repeats.
On repetitive collections the document sets of nearby suffix-tree nodes are
near-identical, so a handful of rules covers most of the data — this is the
mechanism behind PDL's space wins in Figures 6-9.

Implementation notes (host-side build, offline — as in the paper):

* *Batched rounds*: instead of replacing one pair per round, each round
  replaces a maximal set of top-frequency pairs whose symbol sets are
  disjoint (so occurrences cannot chain across different chosen pairs).
  Overlaps within a single pair (the "aaa" case) are resolved leftmost-
  greedily with a vectorized run-parity trick.  This keeps the build
  O(rounds * n) with rounds ~ lg-ish in practice, numpy-vectorized.

* Lists are compressed *jointly* (shared grammar) by concatenating them
  with separator symbols that are excluded from pairing — the paper's PDL
  also shares its grammar across all stored sets.

* Decompression is available host-side (tests, build) and as a bounded
  batched stack expansion in repro_torch.core.pdl (query path).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.common import ceil_log2


@dataclasses.dataclass(frozen=True)
class Grammar:
    """rules[r] = (left, right); nonterminal r encodes symbol alphabet+r.

    seq: the compressed sequence (int64, may contain nonterminals)
    alphabet: first nonterminal id == alphabet
    """

    seq: np.ndarray
    rules: np.ndarray  # int64[nrules, 2]
    alphabet: int

    @property
    def nrules(self) -> int:
        return int(self.rules.shape[0])

    def is_terminal(self, sym) -> bool:
        return sym < self.alphabet

    def expansion_lengths(self) -> np.ndarray:
        """Length of the terminal expansion of every nonterminal."""
        lens = np.zeros(self.nrules, dtype=np.int64)
        for r in range(self.nrules):  # rules reference only older rules
            l, rr = self.rules[r]
            ll = 1 if l < self.alphabet else lens[l - self.alphabet]
            rl = 1 if rr < self.alphabet else lens[rr - self.alphabet]
            lens[r] = ll + rl
        return lens


def _replace_round(seq: np.ndarray, pairs: np.ndarray, first_new: int):
    """Replace every chosen pair (pairs[i] -> symbol first_new + i) in one
    vectorized pass.  Chosen pairs have pairwise-disjoint symbol sets."""
    n = len(seq)
    if n < 2:
        return seq
    key = seq[:-1].astype(np.int64) * (1 << 32) + seq[1:].astype(np.int64)
    pkeys = pairs[:, 0].astype(np.int64) * (1 << 32) + pairs[:, 1].astype(np.int64)
    order = np.argsort(pkeys)
    sorted_keys = pkeys[order]
    idx = np.searchsorted(sorted_keys, key)
    idx_c = np.minimum(idx, len(sorted_keys) - 1)
    hit = sorted_keys[idx_c] == key
    pair_id = np.where(hit, order[idx_c], -1)

    cand = pair_id >= 0
    # leftmost-greedy within runs of consecutive candidates (same pair only,
    # e.g. "aaa" with pair (a,a)); distinct chosen pairs cannot chain.
    pos = np.arange(n - 1)
    run_start = cand & ~np.concatenate([[False], cand[:-1]])
    start_idx = np.maximum.accumulate(np.where(run_start, pos, -1))
    parity_ok = ((pos - start_idx) % 2) == 0
    valid = cand & parity_ok

    out_vals = seq.copy()
    out_vals[np.flatnonzero(valid)] = first_new + pair_id[valid]
    keep = np.ones(n, dtype=bool)
    keep[np.flatnonzero(valid) + 1] = False
    return out_vals[keep]


def repair_compress(
    seq,
    alphabet: int,
    min_freq: int = 2,
    max_rules: int | None = None,
    batch: int = 64,
    separator: int | None = None,
) -> Grammar:
    """Compress ``seq`` (symbols in [0, alphabet)) with Re-Pair.

    separator: symbol excluded from all pairs (list boundaries).
    batch: max number of disjoint pairs replaced per round.
    """
    seq = np.asarray(seq, dtype=np.int64)
    rules: list[tuple[int, int]] = []
    next_sym = alphabet
    while True:
        if max_rules is not None and len(rules) >= max_rules:
            break
        n = len(seq)
        if n < 2:
            break
        key = seq[:-1] * (1 << 32) + seq[1:]
        if separator is not None:
            ok = (seq[:-1] != separator) & (seq[1:] != separator)
            key = key[ok]
        if len(key) == 0:
            break
        uniq, counts = np.unique(key, return_counts=True)
        hot = counts >= min_freq
        if not hot.any():
            break
        uniq, counts = uniq[hot], counts[hot]
        by_count = np.argsort(-counts)
        chosen = []
        used: set[int] = set()
        for j in by_count:
            a = int(uniq[j] >> 32)
            b = int(uniq[j] & 0xFFFFFFFF)
            if a in used or b in used:
                continue
            chosen.append((a, b))
            used.add(a)
            used.add(b)
            if len(chosen) >= batch:
                break
            if max_rules is not None and len(rules) + len(chosen) >= max_rules:
                break
        if not chosen:
            break
        pairs = np.asarray(chosen, dtype=np.int64)
        seq = _replace_round(seq, pairs, next_sym)
        rules.extend(chosen)
        next_sym += len(chosen)
    rules_arr = (
        np.asarray(rules, dtype=np.int64)
        if rules
        else np.zeros((0, 2), dtype=np.int64)
    )
    return Grammar(seq=seq, rules=rules_arr, alphabet=alphabet)


def repair_compress_lists(lists, alphabet: int, **kwargs):
    """Compress many lists with a shared grammar.

    Returns (Grammar over the concatenation-with-separators, list offsets
    into the compressed sequence).  The separator symbol is ``alphabet``;
    rule nonterminals start at ``alphabet + 1``.
    """
    sep = alphabet
    parts = []
    for lst in lists:
        parts.append(np.asarray(lst, dtype=np.int64))
        parts.append(np.asarray([sep], dtype=np.int64))
    cat = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    g = repair_compress(cat, alphabet + 1, separator=sep, **kwargs)
    # split compressed sequence back into per-list segments
    seq = g.seq
    bounds = np.flatnonzero(seq == sep)
    starts = np.concatenate([[0], bounds[:-1] + 1]) if len(bounds) else np.zeros(0, np.int64)
    segments = [seq[s:e] for s, e in zip(starts, bounds)]
    return g, segments


def repair_expand_host(g: Grammar, seq) -> np.ndarray:
    """Expand a (sub)sequence of terminals/nonterminals to terminals."""
    out: list[int] = []
    stack: list[int] = list(np.asarray(seq, dtype=np.int64))[::-1]
    while stack:
        s = stack.pop()
        if s < g.alphabet:
            out.append(int(s))
        else:
            l, r = g.rules[int(s) - g.alphabet]
            stack.append(int(r))
            stack.append(int(l))
    return np.asarray(out, dtype=np.int64)


def modeled_bits_grammar(g: Grammar, d_plus: int | None = None) -> int:
    """Paper accounting: |A| lg(d + n_R) for the sequence array plus
    |G| lg d for the rules, plus the two delimiting bitvectors (Sec 4.1)."""
    width_seq = ceil_log2(g.alphabet + g.nrules + 1)
    width_rule = ceil_log2(max(2, g.alphabet))
    seq_bits = len(g.seq) * width_seq
    rule_bits = 2 * g.nrules * width_rule
    bitvecs = len(g.seq) + 2 * g.nrules + 64
    return int(seq_bits + rule_bits + bitvecs)
