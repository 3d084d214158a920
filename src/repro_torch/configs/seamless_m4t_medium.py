"""seamless-m4t-medium — multimodal enc-dec [arXiv:2308.11596].

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206. Transformer
backbone only: the mel-spectrogram/conv codec frontend is a stub that
supplies precomputed frame embeddings (d_audio=1024).
"""
import torch

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=12,
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    norm="layernorm",
    mlp="gelu",
    n_audio_frames=1024,     # default; input_specs scales with seq_len
    d_audio=1024,
    dtype=torch.bfloat16,
)
