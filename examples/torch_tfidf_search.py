"""Multi-term ranked search (Section 6.5) on the PyTorch/CUDA port over a
versioned text corpus: conjunctive and disjunctive tf-idf with phrase
terms.

    PYTHONPATH=src python examples/torch_tfidf_search.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from repro_torch.core.suffix import concat_documents, encode_pattern
from repro_torch.serve.retrieval import RetrievalService


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()

    rng = np.random.default_rng(7)
    vocab = ["fox", "dog", "cat", "bird", "quick", "lazy", "brown", "jumps"]
    docs = []
    for i in range(24):
        words = [vocab[j] for j in rng.integers(0, len(vocab), 30)]
        words += ["fox"] * (i % 5) + ["dog"] * (i % 3)
        docs.append(" ".join(words))
    coll = concat_documents(docs)
    svc = RetrievalService.build(coll, block_size=32, beta=None, device=args.device)

    queries = [
        (["fox"], False),
        (["fox", "dog"], False),
        (["fox", "dog"], True),
        (["quick brown"], False),     # phrase term: free on a string index
    ]
    for terms, conj in queries:
        encoded = [encode_pattern(t) for t in terms]
        out = svc.tfidf([encoded], k=5, conjunctive=conj)[0]
        kind = "AND" if conj else "OR"
        print(f"{kind:3s} {terms}: " +
              ", ".join(f"doc{d}({s:.2f})" for d, s in out))
        # the batched program against the per-query reference path
        assert out == svc.tfidf([encoded], k=5, conjunctive=conj, engine="reference")[0]
    print(f"reference parity OK; programs per endpoint: {dict(svc.compile_counts)}")


if __name__ == "__main__":
    main()
