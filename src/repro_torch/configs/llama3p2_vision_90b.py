"""llama-3.2-vision-90b — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision, scaled per the 90B card].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer
cross-attends to image tokens. Vision encoder (ViT-H) is a stub supplying
patch embeddings (1600 tokens, d_vision=1280).
"""
import torch

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    cross_attn_every=5,
    n_image_tokens=1600,
    d_vision=1280,
    rope_theta=500_000.0,
    dtype=torch.bfloat16,
)
