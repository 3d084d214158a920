"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
import torch

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    n_layers=88,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
)
