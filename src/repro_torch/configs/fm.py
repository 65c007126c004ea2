"""fm: factorization machine, 39 sparse fields, embed_dim=10, 2-way
interactions via the O(nk) sum-square trick.  [Rendle ICDM'10]  (counterpart of
``repro.configs.fm``)"""
from repro_torch.models.recsys import FMConfig

ARCH_ID = "fm"
FAMILY = "recsys"


def config() -> FMConfig:
    return FMConfig(name=ARCH_ID, n_sparse=39, embed_dim=10)


def reduced_config() -> FMConfig:
    return FMConfig(
        name=ARCH_ID + "-reduced", n_sparse=5, embed_dim=4,
        vocab_sizes=(50, 60, 70, 80, 90),
    )
