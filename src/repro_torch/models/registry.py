"""Family registry: one API over the architecture families (port of the JAX
package's ``models/registry.py``).

    init(seed, cfg, device)        -> params
    loss_fn(params, cfg, batch)    -> scalar loss
    prefill(params, cfg, batch)    -> (logits, cache)
    decode_step(params, cfg, cache, pos, tokens) -> (logits, cache)
    init_decode_cache(params, cfg, batch, max_seq, batch_extras) -> a cache

plus ``param_count`` (on the meta device: nothing is allocated) and the
weight bridge to the reference, ``params_from_numpy``/``params_to_numpy``.
``batch`` is a dict: always {"tokens", "labels"}; plus "image_embeds" for
vlm and "audio_frames" for the audio enc-dec.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree as T
from repro_torch.models import encdec, hybrid, mamba2, moe, transformer, vlm
from repro_torch.models.base import ModelConfig

_FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": hybrid,
    "vlm": vlm,
    "audio": encdec,
}


def family_module(cfg: ModelConfig):
    return _FAMILIES[cfg.family]


def init(seed: int, cfg: ModelConfig, device="cuda"):
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``. They differ from the reference's ``jax.random`` draws;
    to hold the two packages against each other, carry the reference's
    weights across with ``params_from_numpy``."""
    dev = T.resolve_device(device)
    if dev.type == "meta":
        normal = lambda shape: torch.empty(shape, device=dev)  # noqa: E731
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        normal = lambda shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=dev)
    return family_module(cfg).init(normal, cfg, dev)


def loss_fn(params, cfg: ModelConfig, batch):
    return family_module(cfg).loss_fn(params, cfg, batch)


def prefill(params, cfg: ModelConfig, batch, max_seq=None):
    mod = family_module(cfg)
    if cfg.family == "vlm":
        return mod.prefill(params, cfg, batch["tokens"], batch["image_embeds"],
                           max_seq=max_seq)
    if cfg.family == "audio":
        return mod.prefill(params, cfg, batch["tokens"], batch["audio_frames"],
                           max_seq=max_seq)
    return mod.prefill(params, cfg, batch["tokens"], max_seq=max_seq)


def decode_step(params, cfg: ModelConfig, cache, pos, tokens):
    return family_module(cfg).decode_step(params, cfg, cache, pos, tokens)


def init_decode_cache(params, cfg: ModelConfig, batch: int, max_seq: int,
                      batch_extras=None):
    """An empty cache for decoding without a prefill, on the params'
    device. The cross-attention families derive their cross K/V from the
    modality embeddings in ``batch_extras``."""
    mod = family_module(cfg)
    device = T.leaves(params)[0].device
    if cfg.family == "ssm":
        return mod.init_cache(cfg, batch, device=device)
    if cfg.family == "vlm":
        ikv = vlm.image_kv_from_embeds(params, cfg,
                                       batch_extras["image_embeds"])
        return {"self": vlm.init_self_cache(cfg, batch, max_seq, device),
                "image_kv": ikv}
    if cfg.family == "audio":
        enc_out = encdec.encode(params, cfg, batch_extras["audio_frames"])
        return {"self": encdec.init_self_cache(cfg, batch, max_seq, device),
                "cross_kv": encdec.cross_kv(params, cfg, enc_out)}
    return mod.init_cache(cfg, batch, max_seq, device)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg``; with ``active_only``, an MoE model's routed
    experts count top_k / n_experts of theirs (those one token runs)."""
    shapes = init(0, cfg, device="meta")
    total = sum(x.numel() for x in T.leaves(shapes))
    if active_only and cfg.n_experts:
        expert = sum(x.numel()
                     for x in T.leaves(shapes["blocks"]["moe"]["experts"]))
        total = total - expert + expert * cfg.top_k // cfg.n_experts
    return total


def param_bytes(cfg: ModelConfig) -> int:
    return sum(x.numel() * x.element_size()
               for x in T.leaves(init(0, cfg, device="meta")))


def params_from_numpy(tree, device="cuda"):
    """The reference's params (a tree of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's, key for key."""
    return T.from_numpy(tree, device)


def params_to_numpy(params):
    """The port's params -> numpy arrays (bf16 leaves as float32)."""
    return T.to_numpy(params)
