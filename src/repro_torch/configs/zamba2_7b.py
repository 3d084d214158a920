"""zamba2-7b — Mamba2 backbone + shared attention block [arXiv:2411.15242].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
The shared attention block is applied every 6 SSM layers; it uses a 4k
sliding window so long_500k decode stays sub-quadratic (see DESIGN.md §4).
"""
import torch

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    attn_every=6,
    sliding_window=4096,
    dtype=torch.bfloat16,
)
