"""llama4-maverick-400b-a17b: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1 + shared expert, 3:1 local:global.
Optimizer moments run in bf16 for this arch (``OPT_MOMENT_DTYPE``, as the
reference's registry reads it).  [hf:meta-llama/Llama-4-Maverick-17B-128E]
(counterpart of ``repro.configs.llama4_maverick_400b_a17b``)"""
import torch

from repro_torch.models.transformer import LMConfig, MoEConfig

ARCH_ID = "llama4-maverick-400b-a17b"
FAMILY = "lm"
OPT_MOMENT_DTYPE = "bfloat16"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048,
        moe=MoEConfig(n_experts=128, top_k=1, shared_expert=True),
        period=4, local_positions=(0, 1, 2), local_chunk=8192,
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=1, shared_expert=True),
        period=4, local_positions=(0, 1, 2), local_chunk=32,
        param_dtype=torch.float32, act_dtype=torch.float32,
    )
