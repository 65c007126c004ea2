"""sasrec: self-attentive sequential recommendation, embed_dim=50,
2 blocks, 1 head, seq_len=50; 1M-item catalog (retrieval_cand scores the
full catalog).  [arXiv:1808.09781]  (counterpart of
``repro.configs.sasrec``)"""
from repro_torch.models.recsys import SASRecConfig

ARCH_ID = "sasrec"
FAMILY = "recsys"


def config() -> SASRecConfig:
    return SASRecConfig(
        name=ARCH_ID, n_items=1_000_000, embed_dim=50, n_blocks=2,
        n_heads=1, seq_len=50,
    )


def reduced_config() -> SASRecConfig:
    return SASRecConfig(
        name=ARCH_ID + "-reduced", n_items=200, embed_dim=8, n_blocks=2,
        n_heads=1, seq_len=10,
    )
