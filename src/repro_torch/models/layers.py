"""Shared neural-net primitives for the dense model family (port of the JAX
package's ``models/layers.py``).

Functional, like the reference: parameters are nested dicts of tensors and
every layer is ``init_*`` + ``apply_*``. Attention runs blockwise with an
online softmax, or, under ``cfg.use_flash_kernel``, through the hand-written
flash-attention kernel (``kernels.ops.flash_attention``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.base import ModelConfig

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# init helpers: ``normal(shape) -> f32 tensor`` draws N(0, 1) on the target
# device from the caller's generator
# ---------------------------------------------------------------------------


def dense_init(normal, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None):
    scale = scale if scale is not None else d_in ** -0.5
    return (normal((d_in, d_out)) * scale).to(dtype)


def embed_init(normal, vocab: int, d_model: int, dtype):
    return (normal((vocab, d_model)) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms (computed in f32, cast back)
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device):
    dtype = cfg.dtype
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device),
                "bias": torch.zeros(cfg.d_model, dtype=dtype, device=device)}
    if cfg.norm == "nonparametric_ln":  # OLMo: LN without affine params
        return {}
    raise ValueError(f"unknown norm {cfg.norm!r}")


def apply_norm(params, cfg: ModelConfig, x, eps: float = 1e-5):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rmsnorm_raw(x, scale, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (b, s, h, d); positions: (b, s) or (s,) integer tensor."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs
    if angles.ndim == 2:  # (s, d/2) -> broadcast over batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(normal, cfg: ModelConfig, device):
    d_model, n_heads, n_kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(normal, d_model, n_heads * hd, cfg.dtype),
        "wk": dense_init(normal, d_model, n_kv * hd, cfg.dtype),
        "wv": dense_init(normal, d_model, n_kv * hd, cfg.dtype),
        "wo": dense_init(normal, n_heads * hd, d_model, cfg.dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(width * hd, dtype=cfg.dtype, device=device)
    return p


def _repeat_kv(x, n_rep: int):
    """(b, s, kv, d) -> (b, s, kv*n_rep, d) by head-group broadcast."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def blockwise_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                        sliding_window: int = 0, q_block: int = 512):
    """Online-softmax attention over query blocks.

    q: (b, sq, h, d); k, v: (b, skv, h, d). ``q_offset`` is the absolute
    position of q[0] relative to k[0] (decode: the cache index). Scores are
    f32; masked scores are -1e30. Live memory is O(b*h*q_block*skv).
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qf = q.float() * d ** -0.5
    kf = k.float()
    vf = v.float()
    kv_pos = torch.arange(skv, device=q.device)

    q_block = min(q_block, sq)
    outs = []
    for start in range(0, sq, q_block):
        qb = qf[:, start:start + q_block]
        q_pos = q_offset + start + torch.arange(qb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kf)
        mask = torch.ones(qb.shape[1], skv, dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if sliding_window:
            mask &= q_pos[:, None] - kv_pos[None, :] < sliding_window
        s = torch.where(mask, s, NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        denom = torch.sum(p, dim=-1, keepdim=True)
        outs.append(torch.einsum("bhqk,bkhd->bqhd",
                                 p / torch.clamp(denom, min=1e-30), vf))
    return torch.cat(outs, dim=1).to(q.dtype)


def apply_attention(params, cfg: ModelConfig, x, *, positions=None,
                    causal: bool = True, cache: Optional[dict] = None,
                    cache_index: Optional[int] = None):
    """GQA self-attention with an optional KV cache.

    cache: {"k": (b, max_s, kv, d), "v": ...}; the new cache is a copy with
    this call's keys and values written at ``cache_index``. Returns
    (out, new_cache).
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    nq = params["wq"].shape[1] // hd
    nkv = params["wk"].shape[1] // hd
    window = cfg.sliding_window

    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, nq, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)

    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    q_offset = 0
    new_cache = cache
    if cache is not None:
        idx = int(cache_index or 0)
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[:, idx:idx + s] = k.to(ck.dtype)
        cv[:, idx:idx + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        k, v = ck, cv
        q_offset = idx

    n_rep = nq // nkv
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if cfg.use_flash_kernel and cache is None and causal and s > 1:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window, block_q=min(256, s),
            block_k=min(256, s))
        out = out.transpose(1, 2)
    else:
        out = blockwise_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  sliding_window=window)
    out = out.reshape(b, s, nq * hd) @ params["wo"]
    return out, new_cache


def cross_attention(attn, cfg: ModelConfig, x, kv):
    """x's queries against precomputed keys and values ``kv`` ({"k", "v"},
    (b, m, kv, hd)): no rope, no mask, never the flash kernel (it is
    causal only). Returns the output projection, (b, s, d_model)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ attn["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = _repeat_kv(kv["k"], cfg.n_heads // cfg.n_kv_heads)
    v = _repeat_kv(kv["v"], cfg.n_heads // cfg.n_kv_heads)
    o = blockwise_attention(q, k, v, causal=False)
    return o.reshape(b, s, cfg.n_heads * hd) @ attn["wo"]


def cross_query(attn):
    """The parameters of a cross-attention that ``cross_attention`` reads
    in its layer: all but the wk / wv that ``transformer.stacked_kv`` has
    used once (so that a ZeRO-3 layer hook does not gather them again)."""
    return {k: v for k, v in attn.items() if k not in ("wk", "wv")}


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(normal, cfg: ModelConfig, d_ff: Optional[int] = None):
    d_ff, d_model = d_ff or cfg.d_ff, cfg.d_model
    if cfg.mlp == "swiglu":
        return {"wi": dense_init(normal, d_model, d_ff, cfg.dtype),
                "wg": dense_init(normal, d_model, d_ff, cfg.dtype),
                "wo": dense_init(normal, d_ff, d_model, cfg.dtype)}
    return {"wi": dense_init(normal, d_model, d_ff, cfg.dtype),
            "wo": dense_init(normal, d_ff, d_model, cfg.dtype)}


def apply_mlp(params, cfg: ModelConfig, x):
    if "wg" in params:
        return (F.silu(x @ params["wi"]) * (x @ params["wg"])) @ params["wo"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ params["wi"], approximate="tanh") @ params["wo"]


# ---------------------------------------------------------------------------
# embedding / unembedding / loss
# ---------------------------------------------------------------------------


def init_embed(normal, cfg: ModelConfig):
    p = {"tok": embed_init(normal, cfg.vocab_padded, cfg.d_model, cfg.dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(normal, cfg.d_model, cfg.vocab_padded,
                                  cfg.dtype)
    return p


def embed_tokens(params, x):
    return params["tok"][x.long()]


def unembed(params, cfg: ModelConfig, h):
    if cfg.tie_embeddings:
        return h @ params["tok"].T
    return h @ params["unembed"]


def cross_entropy(logits, labels, cfg: ModelConfig):
    """Mean next-token CE; masks vocab-padding columns and label == -1."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > cfg.vocab_size:  # no masked copy when nothing is padded
        col_mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(col_mask, logits, NEG_INF)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = logz - gold
    valid = (labels >= 0).float()
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)
