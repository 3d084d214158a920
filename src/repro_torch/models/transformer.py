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
from repro_torch.distributed import tensor_parallel as tp
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


def gather_layer(tree):
    """The layer hook: one layer's parameters as the layer uses them. The
    identity, except inside a ZeRO-3 step (``launch/steps.py``), which
    hands the layer loops per-layer shards (objects with a ``gather``
    method, not tensors) that are all-gathered here over the data group,
    just before the layer runs. Walks dicts, lists and tuples; tensors
    pass as they are. Under tensor parallelism what the gather gives back
    (or the tensor itself) is this rank's model part of the leaf, which
    the layer takes as it is (``models/layers.py``)."""
    if isinstance(tree, dict):
        return {k: gather_layer(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_layer(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree
    gather = getattr(tree, "gather", None)
    return tree if gather is None else gather()


def remat_wrap(cfg: ModelConfig, body):
    """The layer body: ``body(*args)`` on its layer's parameters, taken
    through ``gather_layer``. With ``cfg.remat`` it keeps none of its
    activations for the backward and recomputes them there
    (``remat_policy`` "full"), or keeps only its projections' outputs
    ("dots"), as the reference's ``jax.checkpoint``; the gather is inside
    the checkpoint, so a ZeRO-3 backward gathers again. A flash-kernel
    forward inside ``body`` runs again in the recompute."""
    def layer(*args):
        return body(*gather_layer(args))
    if not cfg.remat:
        return layer
    context_fn = (_dots_contexts if cfg.remat_policy == "dots"
                  else ckpt.noop_context_fn)

    def wrapped(*args):
        return ckpt.checkpoint(layer, *args, use_reentrant=False,
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


def stacked_zeros(cache: dict, n: int) -> dict:
    """Zeros of a per-layer cache's leaves stacked on a new layer axis of
    n, each (n,) + its shape, in its dtype and on its device."""
    return {k: torch.zeros((n,) + x.shape, dtype=x.dtype, device=x.device)
            for k, x in cache.items()}


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
    """A stacked tree -> n per-layer trees (views, one unbind per leaf). A
    leaf that is not a tensor (a ZeRO-3 step's shards of a stacked leaf)
    unbinds itself into per-layer shards for ``gather_layer``."""
    ls = T.leaves(tree)
    per_leaf = [torch.unbind(x, 0) if isinstance(x, torch.Tensor)
                else x.unbind() for x in ls]
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


def stacked_kv(attn, cfg: ModelConfig, memory, n: int):
    """Cross-attention keys and values of ``memory`` (b, m, d_model, whole
    on every rank) for each of the n layers of a stacked attention's wk /
    wv, each layer's weights taken through ``gather_layer``: {"k", "v"},
    each (n, b, m, kv, hd). Computed once; decode reads them from its
    cache. Under tensor parallelism each is this rank's part, as
    ``cache_specs`` splits ``image_kv/k`` and ``cross_kv/k``
    (``layers.kv_layout``: its kv heads, else its dims of every head,
    else whole)."""
    mem = tp.copy_to_model(memory)
    ws = [gather_layer(w) for w in
          unbind_layers({"k": attn["wk"], "v": attn["wv"]}, n)]
    return {name: torch.stack([L.kv_part(mem, w[name], cfg) for w in ws])
            for name in ("k", "v")}


def _run_blocks(params, cfg: ModelConfig, h, *, positions=None, cache=None,
                cache_index=None):
    body = remat_wrap(cfg, lambda h, bp, c: apply_block(
        bp, cfg, h, positions=positions, cache=c, cache_index=cache_index))
    return run_layers(h, params["blocks"], cache, cfg.n_layers, body)


def forward(params, cfg: ModelConfig, tokens, *, positions=None, cache=None,
            cache_index=None):
    h = L.embed_tokens(params["embed"], tokens, cfg)
    h, new_cache = _run_blocks(params, cfg, h, positions=positions,
                               cache=cache, cache_index=cache_index)
    h = L.apply_norm(params["final_norm"], cfg, h)
    return L.unembed(params["embed"], cfg, h), new_cache


def loss_fn(params, cfg: ModelConfig, batch):
    logits, _ = forward(params, cfg, batch["tokens"])
    return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:], cfg)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    return stacked_zeros(L.init_kv_cache(cfg, batch, max_seq, device),
                         cfg.n_layers)


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
