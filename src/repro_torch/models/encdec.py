"""Seamless-M4T-style encoder-decoder backbone [arXiv:2308.11596]; port of
the JAX package's ``models/encdec.py``.

Transformer backbone only: the mel-spectrogram + conv codec frontend is a
stub, and the model takes precomputed frame embeddings (b, n_frames,
d_audio). Encoder: bidirectional self-attention with rope over the
projected frames. Decoder: causal self-attention, then cross-attention to
the encoder's output, whose keys and values are computed once per layer
(``cross_kv``) and kept in the decode cache.

Only the decoder's causal self-attention without a cache reaches the flash
kernel (``layers.apply_attention``'s gate); the encoder and the
cross-attention run ``blockwise_attention`` with ``causal=False``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.base import ModelConfig


def init_enc_block(normal, cfg: ModelConfig, device):
    return {"ln1": L.init_norm(cfg, device),
            "attn": L.init_attention(normal, cfg, device),
            "ln2": L.init_norm(cfg, device),
            "mlp": L.init_mlp(normal, cfg)}


def init_dec_block(normal, cfg: ModelConfig, device):
    return {"ln1": L.init_norm(cfg, device),
            "self_attn": L.init_attention(normal, cfg, device),
            "ln_x": L.init_norm(cfg, device),
            "cross_attn": L.init_attention(normal, cfg, device),
            "ln2": L.init_norm(cfg, device),
            "mlp": L.init_mlp(normal, cfg)}


def init(normal, cfg: ModelConfig, device):
    return {
        "embed": L.init_embed(normal, cfg),
        "audio_proj": L.dense_init(normal, cfg.d_audio, cfg.d_model,
                                   cfg.dtype),
        "encoder": T.stack_init(lambda: init_enc_block(normal, cfg, device),
                                cfg.n_encoder_layers),
        "enc_norm": L.init_norm(cfg, device),
        "decoder": T.stack_init(lambda: init_dec_block(normal, cfg, device),
                                cfg.n_layers),
        "final_norm": L.init_norm(cfg, device),
    }


def encode(params, cfg: ModelConfig, audio_frames):
    """audio_frames: (b, f, d_audio), cast to cfg.dtype -> (b, f, d_model)."""
    h = audio_frames.to(cfg.dtype) @ params["audio_proj"]

    def body(h, bp, _):
        a, _ = L.apply_attention(bp["attn"], cfg,
                                 L.apply_norm(bp["ln1"], cfg, h), causal=False)
        h = h + a
        h = h + L.apply_mlp(bp["mlp"], cfg, L.apply_norm(bp["ln2"], cfg, h))
        return h, None

    h, _ = T.run_layers(h, params["encoder"], None, cfg.n_encoder_layers,
                        T.remat_wrap(cfg, body))
    return L.apply_norm(params["enc_norm"], cfg, h)


def cross_kv(params, cfg: ModelConfig, enc_out):
    """The decoder's cross-attention K/V, stacked: (L, b, f, kv, hd)."""
    return L.stacked_kv(params["decoder"]["cross_attn"], cfg, enc_out)


def apply_dec_block(bp, cfg: ModelConfig, h, ckv, *, positions=None,
                    cache=None, cache_index=None):
    a, new_cache = L.apply_attention(
        bp["self_attn"], cfg, L.apply_norm(bp["ln1"], cfg, h),
        positions=positions, cache=cache, cache_index=cache_index)
    h = h + a
    h = h + L.cross_attention(bp["cross_attn"], cfg,
                              L.apply_norm(bp["ln_x"], cfg, h), ckv)
    h = h + L.apply_mlp(bp["mlp"], cfg, L.apply_norm(bp["ln2"], cfg, h))
    return h, new_cache


def decode_stack(params, cfg: ModelConfig, tokens, ckv, *, positions=None,
                 cache=None, cache_index=None):
    """The decoder over ``tokens`` against the stacked cross K/V ``ckv``;
    ``cache`` (if given) is the self-attention cache stacked on the layer
    axis. Returns (logits, the new self cache or None)."""
    h = L.embed_tokens(params["embed"], tokens)
    body = T.remat_wrap(cfg, lambda h, x, c: apply_dec_block(
        x["block"], cfg, h, x["kv"], positions=positions, cache=c,
        cache_index=cache_index))
    h, new_cache = T.run_layers(h, {"block": params["decoder"], "kv": ckv},
                                cache, cfg.n_layers, body)
    h = L.apply_norm(params["final_norm"], cfg, h)
    return L.unembed(params["embed"], cfg, h), new_cache


def loss_fn(params, cfg: ModelConfig, batch):
    enc_out = encode(params, cfg, batch["audio_frames"])
    ckv = cross_kv(params, cfg, enc_out)
    logits, _ = decode_stack(params, cfg, batch["tokens"], ckv)
    return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:], cfg)


def init_self_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    device="cuda"):
    return T.init_cache(cfg, batch, max_seq, device)


def prefill(params, cfg: ModelConfig, tokens, audio_frames,
            max_seq: Optional[int] = None):
    b, s = tokens.shape
    enc_out = encode(params, cfg, audio_frames)
    ckv = cross_kv(params, cfg, enc_out)
    cache = init_self_cache(cfg, b, max_seq or s, tokens.device)
    logits, cache = decode_stack(params, cfg, tokens, ckv, cache=cache,
                                 cache_index=0)
    return logits, {"self": cache, "cross_kv": ckv}


def decode_step(params, cfg: ModelConfig, cache, pos: int, tokens):
    """tokens: (b, 1); pos: int index into the self cache. The cross K/V
    is read from the cache, not computed again."""
    positions = torch.full((1,), int(pos), dtype=torch.int64,
                           device=tokens.device)
    logits, new_self = decode_stack(params, cfg, tokens, cache["cross_kv"],
                                    positions=positions, cache=cache["self"],
                                    cache_index=int(pos))
    return logits, {"self": new_self, "cross_kv": cache["cross_kv"]}
