"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention+MLP block
applied after every ``attn_every`` SSM layers [arXiv:2411.15242]; port of
the JAX package's ``models/hybrid.py``.

The shared block's weights are reused at every application site, but each
site keeps its own KV cache. Attention uses a sliding window
(cfg.sliding_window), so decode keeps a ring buffer of ``window`` keys per
site: position t lives in slot t mod window.

Without a cache, and in a prefill from the zero state, the SSM layers
take the SSD kernel under ``cfg.use_ssd_kernel``; without a cache the
shared block's attention takes the flash kernel under
``cfg.use_flash_kernel`` (with the window), as in the SSM and dense
families.

Under tensor parallelism the Mamba2 layers take their heads' parts as in
the SSM family and the shared block is a dense block; each site's ring
holds this rank's part of the keys and values (``layers.kv_layout``: its
kv heads, else its dims of every head), over which decode attends.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import tensor_parallel as tp
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
    x = L.apply_norm(bp["ln1"], cfg, h)
    o, ring = _ring_attend(bp["attn"], cfg, x, attn_cache, pos)
    h = h + o
    h = h + L.apply_mlp(bp["mlp"], cfg, L.apply_norm(bp["ln2"], cfg, h))
    return h, ring


def _ring_attend(attn, cfg: ModelConfig, x, attn_cache, pos: int):
    """One token's attention over the ring's valid slots (not a causal
    mask), its keys and values written into slot pos mod size. Under
    tensor parallelism on this model rank's part of the ring
    (``layers.kv_layout``): its q heads against its kv heads (every kv
    head on a whole ring) and the output projection's rows of those
    heads; on a head-dim ring, every head's q on this rank's dims, the
    scores summed over the model group and the rows of those dims. Summed
    over the model group."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    lo, hi = L.head_bounds(nq)
    layout = L.kv_layout(cfg)
    size = attn_cache["k"].shape[1]
    xc = tp.copy_to_model(x)
    positions = torch.full((1,), int(pos), dtype=torch.int64,
                           device=x.device)
    slot = int(pos) % size
    ck = attn_cache["k"].clone()
    cv = attn_cache["v"].clone()
    ck[:, slot:slot + 1] = L.kv_part(xc, attn["wk"], cfg, positions).to(
        ck.dtype)
    cv[:, slot:slot + 1] = L.kv_part(xc, attn["wv"], cfg).to(cv.dtype)
    valid = torch.arange(size, device=x.device) < min(int(pos) + 1, size)
    if layout == "hd":
        q = (xc @ tp.used_part(attn["wq"], -1, nq * hd, 0, nq * hd)) \
            .reshape(b, 1, nq, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        d_lo, d_hi = tp.bounds(hd)
        o = L.attend_dims(q[..., d_lo:d_hi], ck, cv, hd, valid)
        wo = L.head_dims(tp.used_part(attn["wo"], -2, nq * hd, 0, nq * hd),
                         -2, nq, hd)
    else:
        q = (xc @ tp.used_part(attn["wq"], -1, nq * hd, lo * hd, hi * hd)) \
            .reshape(b, 1, hi - lo, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        n_rep, base = nq // nkv, tp.bounds(nkv)[0] if layout == "kv" else 0
        kk = L.kv_for_heads(ck, lo, hi, n_rep, base).float()
        vv = L.kv_for_heads(cv, lo, hi, n_rep, base).float()
        s = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, kk)
        s = torch.where(valid, s, L.NEG_INF)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vv)
        wo = tp.used_part(attn["wo"], -2, nq * hd, lo * hd, hi * hd)
    o = o.to(x.dtype).reshape(b, 1, -1) @ wo
    return tp.reduce_from_model(o), {"k": ck, "v": cv}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    ng, _ = n_groups(cfg)
    return {"mamba": T.stacked_zeros(M.init_block_cache(cfg, batch, device),
                                     cfg.n_layers),
            "attn": T.stacked_zeros(
                init_attn_cache(cfg, batch, max_seq, device), ng)}


def _shared_block(params, cfg: ModelConfig, h, ring: int):
    """The shared attention + MLP block over a whole sequence. With
    ``ring`` > 0 also the ring cache of that size its decode continues
    from: the last min(ring, s) keys and values, position t in slot
    t mod ring (under tensor parallelism this rank's part of them,
    ``layers.kv_part``)."""
    sp = params["shared"]
    x_in = L.apply_norm(sp["ln1"], cfg, h)
    a, _ = L.apply_attention(sp["attn"], cfg, x_in)
    h = h + a
    h = h + L.apply_mlp(sp["mlp"], cfg, L.apply_norm(sp["ln2"], cfg, h))
    if not ring:
        return h, None
    b, s, _ = h.shape
    xc = tp.copy_to_model(x_in)
    k = L.kv_part(xc, sp["attn"]["wk"], cfg,
                  torch.arange(s, device=h.device))
    v = L.kv_part(xc, sp["attn"]["wv"], cfg)
    take = min(ring, s)
    slots = torch.arange(s - take, s, device=h.device) % ring
    kv = {}
    for name, t in (("k", k), ("v", v)):
        c = torch.zeros((b, ring) + t.shape[2:], dtype=cfg.dtype,
                        device=h.device)
        c[:, slots] = t[:, -take:].to(cfg.dtype)
        kv[name] = c
    return h, kv


def forward_full(params, cfg: ModelConfig, tokens, *, mamba_cache=None,
                 collect_attn_kv: int = 0, from_zero: bool = False):
    """Scoring / prefill: groups of ``attn_every`` Mamba2 layers each
    followed by the shared block, then the remainder layers. Returns
    (logits, the new Mamba2 cache stacked on the layer axis or None, the
    ring caches stacked on the group axis or None). With
    ``collect_attn_kv`` > 0 each site's ring cache of that size is built
    for the decode that follows; ``from_zero`` says that ``mamba_cache``
    holds zeros (``mamba2.mamba_mixer``)."""
    h = L.embed_tokens(params["embed"], tokens, cfg)
    bps = T.unbind_layers(params["blocks"], cfg.n_layers)
    caches = (T.unbind_layers(mamba_cache, cfg.n_layers)
              if mamba_cache is not None else [None] * cfg.n_layers)

    def group(h, g_bps, g_caches):
        ncs = []
        for bp, c in zip(g_bps, g_caches):
            h, nc = M.apply_mamba_block(bp, cfg, h, cache=c,
                                        from_zero=from_zero)
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
        h, nc = M.apply_mamba_block(T.gather_layer(bp), cfg, h, cache=c,
                                    from_zero=from_zero)
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
        collect_attn_kv=ring_size(cfg, max_seq or s), from_zero=True)
    return logits, {"mamba": new_m, "attn": attn_kv}


def decode_step(params, cfg: ModelConfig, cache, pos: int, tokens):
    """tokens: (b, 1); pos: the absolute position of this token."""
    h = L.embed_tokens(params["embed"], tokens, cfg)
    bps = T.unbind_layers(params["blocks"], cfg.n_layers)
    caches = T.unbind_layers(cache["mamba"], cfg.n_layers)
    rings = T.unbind_layers(cache["attn"], n_groups(cfg)[0])
    new_m, new_rings = [], []
    for i, (bp, c) in enumerate(zip(bps, caches)):
        h, nc = M.apply_mamba_block(T.gather_layer(bp), cfg, h, cache=c)
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
