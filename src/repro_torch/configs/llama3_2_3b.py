"""llama3.2-3b: dense 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-3B]  (counterpart of
``repro.configs.llama3_2_3b``)"""
import torch

from repro_torch.models.transformer import LMConfig

ARCH_ID = "llama3.2-3b"
FAMILY = "lm"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256,
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512,
        param_dtype=torch.float32, act_dtype=torch.float32,
    )
