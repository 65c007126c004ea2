"""Quickstart on the PyTorch/CUDA port: build a document-retrieval index
over a repetitive collection and run the paper's three query types plus
tf-idf, all served by the batched engine (one program per query type and
shape bucket, a CUDA graph on the card; see repro_torch.serve.retrieval).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from repro_torch.data.collections import SyntheticSpec, generate
from repro_torch.serve.retrieval import RetrievalService


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()

    # a versioned collection: 20 near-identical revisions of 5 base docs
    coll = generate(
        SyntheticSpec("version", n_base=5, n_variants=20, base_len=300,
                      mutation_rate=0.005, sigma="acgt")
    )
    print(f"collection: n={coll.n} symbols, d={coll.d} documents")

    svc = RetrievalService.build(coll, block_size=32, beta=8.0, device=args.device)
    report = svc.space_report()
    print("\nindex space (bits/char):")
    for k, v in report.items():
        print(f"  {k:22s} {v if isinstance(v, int) else round(v, 3)}")

    # take a few patterns straight out of the text
    text = coll.text
    pats = []
    rng = np.random.default_rng(0)
    while len(pats) < 4:
        p = int(rng.integers(0, coll.n - 6))
        sub = text[p : p + 5]
        if (sub > 0).all():
            pats.append(np.asarray(sub - 1, dtype=np.int32) + 1)

    # one program computes ranges, df, occ AND the engine dispatch
    plan = svc.plan(pats)
    print("\nquery plan (device-computed dispatch):")
    print("  df     :", plan["df"].tolist())
    print("  occ    :", plan["occ"].tolist())
    print("  engine :", plan["engine"].tolist(), "(1=brute, 3=pdl)")
    print("counting cross-check  :", svc.count_ilcp(pats).tolist())

    # batched listing: docs come back as a padded array (ascending ids,
    # -1 sentinels); the list view is a host convenience on top of it
    docs, counts = svc.list_docs_arrays(pats, max_df=coll.d + 1)
    print("\ndocument listing (batched):")
    for i in range(len(pats)):
        row = docs[i, : counts[i]].tolist()
        print(f"  pattern {i}: {counts[i]} docs -> {row[:10]}{'...' if counts[i] > 10 else ''}")

    print("\ntop-5 by term frequency:")
    for i, hits in enumerate(svc.topk(pats, k=5)):
        print(f"  pattern {i}: {hits}")

    print("\nranked-OR tf-idf (2-term queries):")
    out = svc.tfidf([[pats[0], pats[1]], [pats[2], pats[3]]], k=5)
    for i, hits in enumerate(out):
        print(f"  query {i}: {[(d, round(s, 2)) for d, s in hits]}")

    # every batched endpoint is bit-identical to the per-query reference
    assert svc.list_docs(pats) == svc.list_docs(pats, engine="reference")
    print(f"\nreference parity OK; programs per endpoint: "
          f"{dict(svc.compile_counts)}")


if __name__ == "__main__":
    main()
