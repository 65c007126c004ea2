"""smollm-135m: dense 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
[hf:HuggingFaceTB/SmolLM-135M]  (counterpart of
``repro.configs.smollm_135m``)"""
import torch

from repro_torch.models.transformer import LMConfig

ARCH_ID = "smollm-135m"
FAMILY = "lm"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
        d_ff=1536, vocab=49152, tie_embeddings=True,
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, tie_embeddings=True,
        param_dtype=torch.float32, act_dtype=torch.float32,
    )
