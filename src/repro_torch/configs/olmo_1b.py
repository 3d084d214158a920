"""olmo-1b — non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
"""
import torch

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmo-1b",
    family="dense",
    source="arXiv:2402.00838",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    norm="nonparametric_ln",
    dtype=torch.bfloat16,
)
