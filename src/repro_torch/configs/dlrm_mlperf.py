"""dlrm-mlperf: MLPerf DLRM benchmark config (Criteo 1TB): 13 dense +
26 sparse (official per-table row counts, ~188M rows total), embed_dim=128,
bot MLP 13-512-256-128, dot interaction, top MLP 1024-1024-512-256-1.
[arXiv:1906.00091]  (counterpart of
``repro.configs.dlrm_mlperf``)"""
from repro_torch.models.recsys import DLRMConfig

ARCH_ID = "dlrm-mlperf"
FAMILY = "recsys"


def config() -> DLRMConfig:
    return DLRMConfig(name=ARCH_ID)


def reduced_config() -> DLRMConfig:
    return DLRMConfig(
        name=ARCH_ID + "-reduced", n_dense=13, n_sparse=4, embed_dim=16,
        bot_mlp=(32, 16), top_mlp=(32, 16, 1),
        vocab_sizes=(100, 200, 300, 400),
    )
