"""Dense decoder-only transformer (olmo-1b, qwen2.5-3b, phi4-mini,
mistral-large); port of the JAX package's ``models/transformer.py``.

Layers are stacked on a leading layer axis, as in the reference, so weights
carry across key for key. A Python loop over the layers replaces
``lax.scan``; each stacked leaf is unbound once per forward (indexing it
per layer would make autograd allocate a zero tensor the size of the whole
stack for every layer's backward).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core import tree as T
from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig


def _save_dots(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls without batch dims (the projections; a
    3-D activation times a 2-D weight reaches aten as ``mm``), recompute
    the rest: jax's ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return ckpt.create_selective_checkpoint_contexts(_save_dots)


def remat_wrap(cfg: ModelConfig, body):
    """With ``cfg.remat``, ``body(*args)`` keeps none of its activations
    for the backward and recomputes them there (``remat_policy`` "full"),
    or keeps only its projections' outputs ("dots"), as the reference's
    ``jax.checkpoint``. A flash-kernel forward inside ``body`` runs again
    in the recompute."""
    if not cfg.remat:
        return body
    context_fn = (_dots_contexts if cfg.remat_policy == "dots"
                  else ckpt.noop_context_fn)

    def wrapped(*args):
        return ckpt.checkpoint(body, *args, use_reentrant=False,
                               context_fn=context_fn)
    return wrapped


def init_block(normal, cfg: ModelConfig, device):
    return {
        "ln1": L.init_norm(cfg, device),
        "attn": L.init_attention(normal, cfg, device),
        "ln2": L.init_norm(cfg, device),
        "mlp": L.init_mlp(normal, cfg),
    }


def stack_init(fn, n: int):
    """Call a per-layer init n times and stack every leaf on a new axis 0.
    Each layer is copied into the stack as it is drawn, so the peak is the
    stack and one layer, not two stacks."""
    first = fn()
    stacked = [torch.empty((n,) + x.shape, dtype=x.dtype, device=x.device)
               for x in T.leaves(first)]
    for i in range(n):
        layer = first if i == 0 else fn()
        for dst, x in zip(stacked, T.leaves(layer)):
            dst[i].copy_(x)
    return T.unflatten(first, stacked)


def apply_block(bp, cfg: ModelConfig, h, *, positions=None, cache=None,
                cache_index=None):
    a, new_cache = L.apply_attention(
        bp["attn"], cfg, L.apply_norm(bp["ln1"], cfg, h),
        positions=positions, cache=cache, cache_index=cache_index)
    h = h + a
    h = h + L.apply_mlp(bp["mlp"], cfg, L.apply_norm(bp["ln2"], cfg, h))
    return h, new_cache


def init(normal, cfg: ModelConfig, device):
    return {
        "embed": L.init_embed(normal, cfg),
        "blocks": stack_init(lambda: init_block(normal, cfg, device),
                             cfg.n_layers),
        "final_norm": L.init_norm(cfg, device),
    }


def unbind_layers(tree, n: int):
    """A stacked tree -> n per-layer trees (views, one unbind per leaf)."""
    ls = T.leaves(tree)
    per_leaf = [torch.unbind(x, 0) for x in ls]
    return [T.unflatten(tree, [u[i] for u in per_leaf]) for i in range(n)]


def run_layers(h, blocks, cache, n: int, apply):
    """Run ``apply(h, bp, c) -> (h, new_c)`` over the n stacked layers in
    order. ``cache`` (if given) is stacked on the layer axis, and so is
    the returned cache; without one the result's cache is None."""
    bps = unbind_layers(blocks, n)
    caches = unbind_layers(cache, n) if cache is not None else [None] * n
    new_caches = []
    for bp, c in zip(bps, caches):
        h, nc = apply(h, bp, c)
        new_caches.append(nc)
    if cache is None:
        return h, None
    return h, {k: torch.stack([c[k] for c in new_caches]) for k in cache}


def _run_blocks(params, cfg: ModelConfig, h, *, positions=None, cache=None,
                cache_index=None):
    body = remat_wrap(cfg, lambda h, bp, c: apply_block(
        bp, cfg, h, positions=positions, cache=c, cache_index=cache_index))
    return run_layers(h, params["blocks"], cache, cfg.n_layers, body)


def forward(params, cfg: ModelConfig, tokens, *, positions=None, cache=None,
            cache_index=None):
    h = L.embed_tokens(params["embed"], tokens)
    h, new_cache = _run_blocks(params, cfg, h, positions=positions,
                               cache=cache, cache_index=cache_index)
    h = L.apply_norm(params["final_norm"], cfg, h)
    return L.unembed(params["embed"], cfg, h), new_cache


def loss_fn(params, cfg: ModelConfig, batch):
    logits, _ = forward(params, cfg, batch["tokens"])
    return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:], cfg)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    c = L.init_kv_cache(cfg, batch, max_seq, device)
    return {k: torch.zeros((cfg.n_layers,) + x.shape, dtype=x.dtype,
                           device=x.device) for k, x in c.items()}


def prefill(params, cfg: ModelConfig, tokens, max_seq: Optional[int] = None):
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq or s, tokens.device)
    return forward(params, cfg, tokens, cache=cache, cache_index=0)


def decode_step(params, cfg: ModelConfig, cache, pos: int, tokens):
    """tokens: (b, 1); pos: int index into the cache."""
    positions = torch.full((1,), int(pos), dtype=torch.int64,
                           device=tokens.device)
    return forward(params, cfg, tokens, positions=positions, cache=cache,
                   cache_index=int(pos))
