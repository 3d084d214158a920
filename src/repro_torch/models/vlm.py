"""Llama-3.2-Vision-style VLM decoder [hf:meta-llama/Llama-3.2-11B-Vision];
port of the JAX package's ``models/vlm.py``.

Language backbone only: the vision encoder is a stub, and the model takes
precomputed patch embeddings (b, n_image_tokens, d_vision). The backbone
is a dense GQA decoder in which every ``cross_attn_every``-th layer is a
gated cross-attention layer over the projected image tokens. Layers run
in groups of (cross_attn_every - 1) self layers and one cross layer; the
self layers' weights and caches are stacked on one (G * per_self) axis, as
in the reference, and taken per group.

The self layers' causal attention without a cache reaches the flash kernel
under ``cfg.use_flash_kernel``; the cross layers never do.

Under tensor parallelism ``vision_proj`` and the gates are whole on every
rank, the self layers run as in the dense family, and the image K/V is
this rank's part (``transformer.stacked_kv``), which
``layers.cross_attention`` attends.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.base import ModelConfig


def group_shape(cfg: ModelConfig):
    per = cfg.cross_attn_every
    assert cfg.n_layers % per == 0, "n_layers must divide into cross groups"
    return cfg.n_layers // per, per - 1  # (n_groups, self_layers_per_group)


def init_cross_block(normal, cfg: ModelConfig, device):
    return {
        "ln1": L.init_norm(cfg, device),
        "attn": L.init_attention(normal, cfg, device),
        "ln2": L.init_norm(cfg, device),
        "mlp": L.init_mlp(normal, cfg),
        # tanh-gated residuals, closed at init as in the reference
        "gate_attn": torch.zeros((), dtype=cfg.dtype, device=device),
        "gate_mlp": torch.zeros((), dtype=cfg.dtype, device=device),
    }


def apply_cross_block(bp, cfg: ModelConfig, h, image_kv):
    """image_kv: {"k": (b, n_img, kv, hd), "v": ...} precomputed."""
    o = L.cross_attention(bp["attn"], cfg, L.apply_norm(bp["ln1"], cfg, h),
                          image_kv)
    h = h + torch.tanh(tp.seq_leaf(bp["gate_attn"])) * o
    m = L.apply_mlp(bp["mlp"], cfg, L.apply_norm(bp["ln2"], cfg, h))
    return h + torch.tanh(tp.seq_leaf(bp["gate_mlp"])) * m


def image_kv_from_embeds(params, cfg: ModelConfig, image_embeds):
    """Project the stubbed vision embeddings (cast to cfg.dtype) and
    compute each group's cross K/V: (b, n_img, d_vision) -> stacked
    {"k", "v"}: (G, b, n_img, kv, hd)."""
    x = image_embeds.to(cfg.dtype) @ params["vision_proj"]
    return T.stacked_kv(params["cross"]["attn"], cfg, x,
                        group_shape(cfg)[0])


def init(normal, cfg: ModelConfig, device):
    ng, per_self = group_shape(cfg)
    return {
        "embed": L.init_embed(normal, cfg),
        "vision_proj": L.dense_init(normal, cfg.d_vision, cfg.d_model,
                                    cfg.dtype),
        "blocks": T.stack_init(lambda: T.init_block(normal, cfg, device),
                               ng * per_self),
        "cross": T.stack_init(lambda: init_cross_block(normal, cfg, device),
                              ng),
        "final_norm": L.init_norm(cfg, device),
    }


def forward(params, cfg: ModelConfig, tokens, image_kv, *, positions=None,
            self_cache=None, cache_index=None):
    """Returns (logits, the new self cache stacked (G * per_self, ...) or
    None)."""
    ng, per_self = group_shape(cfg)
    h = L.embed_tokens(params["embed"], tokens, cfg)
    bps = T.unbind_layers(params["blocks"], ng * per_self)
    caches = (T.unbind_layers(self_cache, ng * per_self)
              if self_cache is not None else [None] * (ng * per_self))
    blocks = dict(params["cross"], attn=L.cross_query(params["cross"]["attn"]))
    cross = T.unbind_layers({"block": blocks, "kv": image_kv}, ng)

    def group(h, g_bps, g_caches, x):
        ncs = []
        for bp, c in zip(g_bps, g_caches):
            h, nc = T.apply_block(bp, cfg, h, positions=positions, cache=c,
                                  cache_index=cache_index)
            ncs.append(nc)
        return apply_cross_block(x["block"], cfg, h, x["kv"]), ncs

    body = T.remat_wrap(cfg, group)     # one group at a time, as the reference
    new = []
    for g in range(ng):
        layers = slice(g * per_self, (g + 1) * per_self)
        h, ncs = body(h, bps[layers], caches[layers], cross[g])
        new += ncs
    h = L.apply_norm(params["final_norm"], cfg, h)
    logits = L.unembed(params["embed"], cfg, h)
    new_cache = None
    if self_cache is not None:
        new_cache = {k: torch.stack([c[k] for c in new]) for k in self_cache}
    return logits, new_cache


def loss_fn(params, cfg: ModelConfig, batch):
    ikv = image_kv_from_embeds(params, cfg, batch["image_embeds"])
    logits, _ = forward(params, cfg, batch["tokens"], ikv)
    return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:], cfg)


def init_self_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    device="cuda"):
    ng, per_self = group_shape(cfg)
    return T.init_cache(cfg.replace(n_layers=ng * per_self), batch, max_seq,
                        device)


def prefill(params, cfg: ModelConfig, tokens, image_embeds,
            max_seq: Optional[int] = None):
    b, s = tokens.shape
    ikv = image_kv_from_embeds(params, cfg, image_embeds)
    self_cache = init_self_cache(cfg, b, max_seq or s, tokens.device)
    logits, self_cache = forward(params, cfg, tokens, ikv,
                                 self_cache=self_cache, cache_index=0)
    return logits, {"self": self_cache, "image_kv": ikv}


def decode_step(params, cfg: ModelConfig, cache, pos: int, tokens):
    """tokens: (b, 1); pos: int index into the self cache. The image K/V
    is read from the cache, not computed again."""
    positions = torch.full((1,), int(pos), dtype=torch.int64,
                           device=tokens.device)
    logits, new_self = forward(params, cfg, tokens, cache["image_kv"],
                               positions=positions, self_cache=cache["self"],
                               cache_index=int(pos))
    return logits, {"self": new_self, "image_kv": cache["image_kv"]}
