"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention+MLP block
applied after every ``attn_every`` SSM layers [arXiv:2411.15242]; port of
the JAX package's ``models/hybrid.py``.

The shared block's weights are reused at every application site, but each
site keeps its own KV cache. Attention uses a sliding window
(cfg.sliding_window), so decode keeps a ring buffer of ``window`` keys per
site: position t lives in slot t mod window.

Without a cache the SSM layers take the SSD kernel under
``cfg.use_ssd_kernel`` and the shared block's attention the flash kernel
under ``cfg.use_flash_kernel`` (with the window), as in the SSM and dense
families.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models.base import ModelConfig


def n_groups(cfg: ModelConfig):
    return cfg.n_layers // cfg.attn_every, cfg.n_layers % cfg.attn_every


def init(normal, cfg: ModelConfig, device):
    return {
        "embed": L.init_embed(normal, cfg),
        "blocks": T.stack_init(lambda: M.init_mamba_block(normal, cfg, device),
                               cfg.n_layers),
        "shared": T.init_block(normal, cfg, device),  # one block, reused
        "final_norm": L.init_norm(cfg, device),
    }


# -- ring-buffer windowed attention cache ----------------------------------


def ring_size(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window \
        else max_seq


def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    device="cuda"):
    return L.init_kv_cache(cfg, batch, ring_size(cfg, max_seq), device)


def shared_attn_decode(bp, cfg: ModelConfig, h, attn_cache, pos: int):
    """One-token attention against a ring-buffer window cache. Returns
    (h, the cache with this token's keys and values in slot pos mod
    size)."""
    b = h.shape[0]
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    size = attn_cache["k"].shape[1]
    x = L.apply_norm(bp["ln1"], cfg, h)
    q = (x @ bp["attn"]["wq"]).reshape(b, 1, nq, hd)
    k = (x @ bp["attn"]["wk"]).reshape(b, 1, nkv, hd)
    v = (x @ bp["attn"]["wv"]).reshape(b, 1, nkv, hd)
    positions = torch.full((1,), int(pos), dtype=torch.int64,
                           device=h.device)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    slot = int(pos) % size
    ck = attn_cache["k"].clone()
    cv = attn_cache["v"].clone()
    ck[:, slot:slot + 1] = k.to(ck.dtype)
    cv[:, slot:slot + 1] = v.to(cv.dtype)
    kk = L._repeat_kv(ck, nq // nkv).float()
    vv = L._repeat_kv(cv, nq // nkv).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, kk)
    valid = torch.arange(size, device=h.device) < min(int(pos) + 1, size)
    s = torch.where(valid, s, L.NEG_INF)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vv)
    o = o.to(h.dtype).reshape(b, 1, nq * hd) @ bp["attn"]["wo"]
    h = h + o
    h = h + L.apply_mlp(bp["mlp"], cfg, L.apply_norm(bp["ln2"], cfg, h))
    return h, {"k": ck, "v": cv}


def _stacked(c: dict, n: int) -> dict:
    return {k: torch.zeros((n,) + x.shape, dtype=x.dtype, device=x.device)
            for k, x in c.items()}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    ng, _ = n_groups(cfg)
    return {"mamba": _stacked(M.init_block_cache(cfg, batch, device),
                              cfg.n_layers),
            "attn": _stacked(init_attn_cache(cfg, batch, max_seq, device),
                             ng)}


def _shared_block(params, cfg: ModelConfig, h, ring: int):
    """The shared attention + MLP block over a whole sequence. With
    ``ring`` > 0 also the ring cache of that size its decode continues
    from: the last min(ring, s) keys and values, position t in slot
    t mod ring."""
    sp = params["shared"]
    b, s, _ = h.shape
    x_in = L.apply_norm(sp["ln1"], cfg, h)
    a, _ = L.apply_attention(sp["attn"], cfg, x_in)
    h = h + a
    h = h + L.apply_mlp(sp["mlp"], cfg, L.apply_norm(sp["ln2"], cfg, h))
    if not ring:
        return h, None
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    k = (x_in @ sp["attn"]["wk"]).reshape(b, s, nkv, hd)
    v = (x_in @ sp["attn"]["wv"]).reshape(b, s, nkv, hd)
    k = L.apply_rope(k, torch.arange(s, device=h.device), cfg.rope_theta)
    take = min(ring, s)
    slots = torch.arange(s - take, s, device=h.device) % ring
    kv = {}
    for name, t in (("k", k), ("v", v)):
        c = torch.zeros(b, ring, nkv, hd, dtype=cfg.dtype, device=h.device)
        c[:, slots] = t[:, -take:].to(cfg.dtype)
        kv[name] = c
    return h, kv


def forward_full(params, cfg: ModelConfig, tokens, *, mamba_cache=None,
                 collect_attn_kv: int = 0):
    """Scoring / prefill: groups of ``attn_every`` Mamba2 layers each
    followed by the shared block, then the remainder layers. Returns
    (logits, the new Mamba2 cache stacked on the layer axis or None, the
    ring caches stacked on the group axis or None). With
    ``collect_attn_kv`` > 0 each site's ring cache of that size is built
    for the decode that follows."""
    h = L.embed_tokens(params["embed"], tokens)
    bps = T.unbind_layers(params["blocks"], cfg.n_layers)
    caches = (T.unbind_layers(mamba_cache, cfg.n_layers)
              if mamba_cache is not None else [None] * cfg.n_layers)

    def group(h, g_bps, g_caches):
        ncs = []
        for bp, c in zip(g_bps, g_caches):
            h, nc = M.apply_mamba_block(bp, cfg, h, cache=c)
            ncs.append(nc)
        h, kv = _shared_block(params, cfg, h, collect_attn_kv)
        return h, ncs, kv

    body = T.remat_wrap(cfg, group)     # one group at a time, as the reference
    per = cfg.attn_every
    ng, _ = n_groups(cfg)
    new_m, rings = [], []
    for g in range(ng):
        h, ncs, kv = body(h, bps[g * per:(g + 1) * per],
                          caches[g * per:(g + 1) * per])
        new_m += ncs
        rings.append(kv)
    for bp, c in zip(bps[ng * per:], caches[ng * per:]):  # the remainder
        h, nc = M.apply_mamba_block(bp, cfg, h, cache=c)
        new_m.append(nc)
    h = L.apply_norm(params["final_norm"], cfg, h)
    logits = L.unembed(params["embed"], cfg, h)
    new_mcache = None
    if mamba_cache is not None:
        new_mcache = {k: torch.stack([c[k] for c in new_m])
                      for k in mamba_cache}
    attn_kv = None
    if collect_attn_kv and rings:
        attn_kv = {k: torch.stack([r[k] for r in rings]) for k in ("k", "v")}
    return logits, new_mcache, attn_kv


def loss_fn(params, cfg: ModelConfig, batch):
    logits, _, _ = forward_full(params, cfg, batch["tokens"])
    return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:], cfg)


def prefill(params, cfg: ModelConfig, tokens, max_seq: Optional[int] = None):
    b, s = tokens.shape
    mcache = M.init_cache(cfg, b, device=tokens.device)
    logits, new_m, attn_kv = forward_full(
        params, cfg, tokens, mamba_cache=mcache,
        collect_attn_kv=ring_size(cfg, max_seq or s))
    return logits, {"mamba": new_m, "attn": attn_kv}


def decode_step(params, cfg: ModelConfig, cache, pos: int, tokens):
    """tokens: (b, 1); pos: the absolute position of this token."""
    h = L.embed_tokens(params["embed"], tokens)
    bps = T.unbind_layers(params["blocks"], cfg.n_layers)
    caches = T.unbind_layers(cache["mamba"], cfg.n_layers)
    rings = T.unbind_layers(cache["attn"], n_groups(cfg)[0])
    new_m, new_rings = [], []
    for i, (bp, c) in enumerate(zip(bps, caches)):
        h, nc = M.apply_mamba_decode(bp, cfg, h, c)
        new_m.append(nc)
        if (i + 1) % cfg.attn_every == 0:
            h, ring = shared_attn_decode(params["shared"], cfg, h,
                                         rings[len(new_rings)], pos)
            new_rings.append(ring)
    h = L.apply_norm(params["final_norm"], cfg, h)
    logits = L.unembed(params["embed"], cfg, h)
    return logits, {
        "mamba": {k: torch.stack([c[k] for c in new_m])
                  for k in cache["mamba"]},
        "attn": {k: torch.stack([r[k] for r in new_rings])
                 for k in ("k", "v")}}
