"""mistral-large-123b: dense 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407]  (counterpart of
``repro.configs.mistral_large_123b``)"""
import torch

from repro_torch.models.transformer import LMConfig

ARCH_ID = "mistral-large-123b"
FAMILY = "lm"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=28672, vocab=32768,
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512,
        param_dtype=torch.float32, act_dtype=torch.float32,
    )
