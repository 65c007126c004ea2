"""Document-collection generators (Section 6.1.1) and query workloads.

Counterpart of ``repro.data.collections``: numpy code that gives, for the
same seed, the same collections and patterns as the reference.  Only
``random_substring_patterns`` touches the device, through the port's own
``build_suffix_data``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.suffix import Collection, _sa_range, build_suffix_data, concat_documents
from repro_torch.errors import InvalidQueryError

DNA = "acgt"


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    family: str            # dna | concat | version
    n_base: int
    n_variants: int        # per base document
    base_len: int
    mutation_rate: float
    sigma: str = DNA
    seed: int = 0


def _mutate(rng, doc: np.ndarray, rate: float, alphabet_size: int) -> np.ndarray:
    out = doc.copy()
    mask = rng.random(len(doc)) < rate
    out[mask] = rng.integers(0, alphabet_size, mask.sum())
    return out


def generate(spec: SyntheticSpec) -> Collection:
    rng = np.random.default_rng(spec.seed)
    sigma = len(spec.sigma)
    seed_seq = rng.integers(0, sigma, spec.base_len)
    bases = [
        _mutate(rng, seed_seq, 10 * spec.mutation_rate, sigma)
        for _ in range(spec.n_base)
    ]
    variants_per_base = [
        [_mutate(rng, base, spec.mutation_rate, sigma) for _ in range(spec.n_variants)]
        for base in bases
    ]
    if spec.family == "concat":
        docs = [np.concatenate(vs) for vs in variants_per_base]
    else:  # dna / version: each variant is a document
        docs = [v for vs in variants_per_base for v in vs]
    return concat_documents(docs)


def paperlike_collections(scale: float = 1.0, seed: int = 0):
    """A set of collections spanning the paper's repetitiveness regimes."""
    def s(x):
        return max(2, int(x * scale))

    return {
        "dna-p001": SyntheticSpec("dna", n_base=1, n_variants=s(100), base_len=s(1000),
                                  mutation_rate=0.001, seed=seed),
        "dna-p03": SyntheticSpec("dna", n_base=1, n_variants=s(100), base_len=s(1000),
                                 mutation_rate=0.03, seed=seed),
        "version-p001": SyntheticSpec("version", n_base=s(10), n_variants=s(10),
                                      base_len=s(1000), mutation_rate=0.001, seed=seed),
        "version-p01": SyntheticSpec("version", n_base=s(10), n_variants=s(10),
                                     base_len=s(1000), mutation_rate=0.01, seed=seed),
        "concat-p003": SyntheticSpec("concat", n_base=s(10), n_variants=s(10),
                                     base_len=s(1000), mutation_rate=0.003, seed=seed),
        "random": SyntheticSpec("version", n_base=s(100), n_variants=1,
                                base_len=s(1000), mutation_rate=1.0, seed=seed),
    }


# ---------------------------------------------------------------------------
# Query workloads (Section 6.1.2)
# ---------------------------------------------------------------------------


def random_substring_patterns(
    coll: Collection, n_extract: int, length: int, keep: int, seed: int = 1,
    by_occ_df_ratio: bool = True, *, device="cuda", data=None,
):
    """Extract random substrings, dedupe, keep those with the largest
    occ/df.  ``data`` reuses a ``SuffixData`` of ``coll`` already built;
    otherwise one is built on ``device``."""
    rng = np.random.default_rng(seed)
    text = coll.text
    n = coll.n
    cands = set()
    for _ in range(n_extract):
        p = int(rng.integers(0, max(1, n - length)))
        sub = text[p : p + length]
        if (sub == 0).any():
            continue
        cands.add(tuple(int(x) for x in sub))
    cands = sorted(cands)
    if not by_occ_df_ratio or not cands:
        return [np.asarray(c, dtype=np.int32) for c in cands[:keep]]

    if data is None:
        data = build_suffix_data(coll, device)
    sa = data.sa.cpu().numpy()
    da = data.da.cpu().numpy()
    scored = []
    for c in cands:
        pat = np.asarray(c, dtype=np.int32)
        lo, hi = _sa_range(text, sa, pat)
        occ = hi - lo
        if occ == 0:
            continue
        df = len(set(da[lo:hi].tolist()))
        scored.append((occ / df, pat))
    scored.sort(key=lambda t: -t[0])
    return [pat for _, pat in scored[:keep]]


def normalize_patterns(patterns, *, sigma: int | None = None,
                       max_len: int | None = None):
    """The single input-hardening gate for every query endpoint.

    Structurally bad input (``None``, floats, nested payloads, arbitrary
    objects) raises ``InvalidQueryError``; soft-invalid input (empty,
    longer than ``max_len``, symbols outside ``[0, sigma)``) normalizes to
    a zero-length pattern.  ``str``/``bytes`` map byte-wise to [1, 256].
    Returns a list of 1-D ``np.int32`` arrays.
    """
    _empty = np.zeros(0, np.int32)
    out = []
    for i, p in enumerate(patterns):
        if isinstance(p, str):
            a = np.frombuffer(p.encode("utf-8"), dtype=np.uint8).astype(np.int32) + 1
        elif isinstance(p, (bytes, bytearray)):
            a = np.frombuffer(bytes(p), dtype=np.uint8).astype(np.int32) + 1
        else:
            try:
                a = np.asarray(p)
            except Exception as e:
                raise InvalidQueryError(
                    f"pattern {i}: not convertible to an array ({type(p).__name__})"
                ) from e
            if a.ndim != 1:
                raise InvalidQueryError(
                    f"pattern {i}: expected a 1-D symbol sequence, got shape"
                    f" {a.shape}"
                )
            if a.size and a.dtype.kind not in "iu":
                raise InvalidQueryError(
                    f"pattern {i}: expected integer symbols or str, got dtype"
                    f" {a.dtype}"
                )
            a = a.astype(np.int32, copy=False)
        if max_len is not None and a.size > max_len:
            a = _empty          # longer than any length bucket: cannot serve
        elif sigma is not None and a.size and (
            (a < 0).any() or (a >= sigma).any()
        ):
            a = _empty          # out-of-alphabet symbol: zero occurrences
        out.append(a)
    return out


def pad_patterns(patterns, max_m: int | None = None):
    """Pad to a dense [Q, max_m] batch + lengths (the serving layout)."""
    if not patterns:
        return np.zeros((0, 1), np.int32), np.zeros(0, np.int32)
    max_m = max_m or max(len(p) for p in patterns)
    out = np.zeros((len(patterns), max_m), np.int32)
    lens = np.zeros(len(patterns), np.int32)
    for i, p in enumerate(patterns):
        out[i, : len(p)] = p[:max_m]
        lens[i] = min(len(p), max_m)
    return out, lens
