"""autoint: attention-based feature interactions, 39 sparse fields,
embed_dim=16, 3 attention layers, 2 heads, d_attn=32.  [arXiv:1810.11921]  (counterpart of
``repro.configs.autoint``)"""
from repro_torch.models.recsys import AutoIntConfig

ARCH_ID = "autoint"
FAMILY = "recsys"


def config() -> AutoIntConfig:
    return AutoIntConfig(
        name=ARCH_ID, n_sparse=39, embed_dim=16, n_attn_layers=3,
        n_heads=2, d_attn=32,
    )


def reduced_config() -> AutoIntConfig:
    return AutoIntConfig(
        name=ARCH_ID + "-reduced", n_sparse=5, embed_dim=8,
        n_attn_layers=2, n_heads=2, d_attn=8,
        vocab_sizes=(50, 60, 70, 80, 90),
    )
