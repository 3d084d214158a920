"""arctic-480b — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) per-expert d_ff=4864 vocab=32000.
"""
import torch

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    dtype=torch.bfloat16,
)
