"""Frozen copy of the synthetic collection generator (the paper's
Section 6.1.1), as ``repro_torch.data.collections.generate`` renders it:
a base sequence, bases mutated at ten times the rate, variants of each base
mutated at the rate; every variant one document (``dna``, ``version``) or
the variants of a base concatenated into one (``concat``).

Documents are concatenated with the terminator 0 after each and symbols
shifted by +1, so the text's alphabet is [0, len(alphabet)].
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Collection:
    text: np.ndarray        # int32[n], 0 ends each document
    doc_starts: np.ndarray  # int32[d]
    doc_ends: np.ndarray    # int32[d], the offset of each terminator
    d: int
    sigma: int              # max symbol + 1

    @property
    def n(self) -> int:
        return int(self.text.shape[0])


def _mutate(rng, doc: np.ndarray, rate: float, alphabet_size: int) -> np.ndarray:
    out = doc.copy()
    mask = rng.random(len(doc)) < rate
    out[mask] = rng.integers(0, alphabet_size, mask.sum())
    return out


def concat_documents(docs) -> Collection:
    parts, starts, ends, off = [], [], [], 0
    for doc in docs:
        a = np.asarray(doc, dtype=np.int32) + 1
        starts.append(off)
        off += len(a)
        ends.append(off)
        off += 1
        parts += [a, np.zeros(1, np.int32)]
    text = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    return Collection(text=text, doc_starts=np.asarray(starts, np.int32),
                      doc_ends=np.asarray(ends, np.int32), d=len(starts),
                      sigma=int(text.max()) + 1 if text.size else 1)


def generate(family: str, n_base: int, n_variants: int, base_len: int,
             mutation_rate: float, alphabet: str, seed: int) -> Collection:
    """The collection of one configuration's ``collection`` block and a seed."""
    rng = np.random.default_rng(seed)
    sigma = len(alphabet)
    seed_seq = rng.integers(0, sigma, base_len)
    bases = [_mutate(rng, seed_seq, 10 * mutation_rate, sigma) for _ in range(n_base)]
    variants = [[_mutate(rng, base, mutation_rate, sigma) for _ in range(n_variants)]
                for base in bases]
    if family == "concat":
        docs = [np.concatenate(vs) for vs in variants]
    elif family in ("dna", "version"):
        docs = [v for vs in variants for v in vs]
    else:
        raise ValueError(f"unknown collection family {family!r}")
    return concat_documents(docs)
