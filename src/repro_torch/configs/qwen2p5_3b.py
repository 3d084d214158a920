"""qwen2.5-3b — GQA (kv=2), QKV bias [hf:Qwen/Qwen2.5-0.5B family].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""
import torch

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-3b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11_008,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
)
