"""Architecture registry: the 10 assigned architectures, the 4 input
shapes, the reduced (smoke-test) variants, and a shape's model inputs and
modality stubs (``input_specs``, ``batch_extras``) as meta tensors.

``reduced_batch`` draws its tokens from a numpy seed, so both packages can
be fed the same batch.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

from repro_torch.configs import (arctic_480b, llama3p2_vision_90b,
                                 mamba2_2p7b, mistral_large_123b, olmo_1b,
                                 phi4_mini_3p8b, qwen2_moe_a2p7b, qwen2p5_3b,
                                 seamless_m4t_medium, zamba2_7b)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (mamba2_2p7b, seamless_m4t_medium, qwen2_moe_a2p7b, arctic_480b,
              olmo_1b, qwen2p5_3b, phi4_mini_3p8b, llama3p2_vision_90b,
              zamba2_7b, mistral_large_123b)
}

LONG_CONTEXT_ARCHS = ("mamba2-2.7b", "zamba2-7b")


def supports(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True


def pairs():
    """All (arch, shape) combinations (10x4 minus skips)."""
    for a in ARCHS:
        for s in INPUT_SHAPES:
            if supports(a, s):
                yield a, s


def n_frames_for(cfg: ModelConfig, seq_len: int) -> int:
    return max(seq_len // 4, 16)


def batch_extras(cfg: ModelConfig, batch: int, seq_len: int) -> Dict:
    """Modality-frontend stubs as meta-device tensors of the shapes and
    dtype the models take: vlm's patch embeddings, audio's frame
    embeddings."""
    def meta(*shape):
        return torch.empty(shape, dtype=cfg.dtype, device="meta")
    out = {}
    if cfg.family == "vlm":
        out["image_embeds"] = meta(batch, cfg.n_image_tokens, cfg.d_vision)
    if cfg.family == "audio":
        out["audio_frames"] = meta(batch, n_frames_for(cfg, seq_len),
                                   cfg.d_audio)
    return out


def reduced(cfg: ModelConfig) -> ModelConfig:
    """The reference's smoke-test variant: 2 layers, d_model 128, f32."""
    kw = dict(
        n_layers=2,
        d_model=128,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 997),
        dtype=torch.float32,
        remat=False,
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, 4 * cfg.n_kv_heads // cfg.n_heads)
        kw["head_dim"] = 32
    if cfg.n_experts:
        kw["n_experts"] = 4
        kw["top_k"] = min(cfg.top_k, 2)
        kw["n_shared_experts"] = min(cfg.n_shared_experts, 2)
        kw["moe_capacity_factor"] = float(4 // min(cfg.top_k, 2))
    if cfg.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_headdim"] = 16
        kw["ssm_chunk"] = 16
    if cfg.attn_every:
        kw["attn_every"] = 2
        kw["n_layers"] = 5
        kw["sliding_window"] = 32
    if cfg.cross_attn_every:
        kw["cross_attn_every"] = 2
        kw["n_layers"] = 4
        kw["n_image_tokens"] = 16
        kw["d_vision"] = 64
    if cfg.is_encdec:
        kw["n_encoder_layers"] = 2
        kw["n_audio_frames"] = 32
        kw["d_audio"] = 64
    return cfg.replace(**kw)


def reduced_batch(cfg: ModelConfig, batch: int = 2, seq: int = 32,
                  seed: int = 0) -> Dict[str, np.ndarray]:
    """Concrete small batch for a reduced config, as numpy arrays drawn from
    ``RandomState(seed)`` (hand them to either package)."""
    rng = np.random.RandomState(seed)  # simlint: ok(det-raw-randomstate, the numpy draw both packages are handed in the parity tests; it must stay bit-equal)
    toks = rng.randint(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    out = {"tokens": toks, "labels": toks.copy()}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.randn(
            batch, cfg.n_image_tokens, cfg.d_vision).astype(np.float32)
    if cfg.family == "audio":
        out["audio_frames"] = rng.randn(
            batch, cfg.n_audio_frames, cfg.d_audio).astype(np.float32)
    return out


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict:
    """Model inputs for one workload shape, as meta tensors (int32 tokens,
    as the reference's; the embedding takes them as they are):

    train:    {tokens, labels, (extras)}                -> train step
    prefill:  {tokens, (extras)}                        -> prefill step
    decode:   {tokens: (b, 1), pos: 0-dim, (extras)}    -> serve step
              (the cache is derived apart: ``launch/steps.py::
              decode_cache_shapes``)"""
    b, s = shape.global_batch, shape.seq_len

    def meta(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")
    if shape.kind == "train":
        specs = {"tokens": meta(b, s), "labels": meta(b, s)}
    elif shape.kind == "prefill":
        specs = {"tokens": meta(b, s)}
    elif shape.kind == "decode":
        specs = {"tokens": meta(b, 1), "pos": meta()}
    else:
        raise ValueError(shape.kind)
    specs.update(batch_extras(cfg, b, s))
    return specs
