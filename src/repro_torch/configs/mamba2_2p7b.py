"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560, attention-free, d_ff=0, vocab=50280, ssm_state=128.
"""
import torch

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    norm="rmsnorm",
    dtype=torch.bfloat16,
)
