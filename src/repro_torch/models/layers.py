"""Shared neural-net primitives for the dense model family (port of the JAX
package's ``models/layers.py``).

Functional, like the reference: parameters are nested dicts of tensors and
every layer is ``init_*`` + ``apply_*``. Attention runs blockwise with an
online softmax, or, under ``cfg.use_flash_kernel``, through the hand-written
flash-attention kernel (``kernels.ops.flash_attention``).

Under tensor parallelism (``distributed/tensor_parallel.py``, a model group
of more than one rank) a layer takes what this rank holds of each leaf,
its model part as the sharding specs split it or the whole leaf, and
tells the two apart by shape against the config's full widths: attention
runs this rank's heads (``tp.bounds(n_heads)``), the MLP its columns of
the hidden width, the embedding, unembedding and loss their rows of the
vocabulary. Where a part falls inside a head (the specs split the
flattened head columns whenever they divide: qwen2.5-3b's two KV heads on
8 ranks, phi4-mini's 24 heads on 16), the layer gathers that leaf over
the model group and takes the heads it needs; the alternative, contracting
the split head dim with an all-reduce of partial scores, would cut
attention's work by rank only for the q-k product and would need the
rotary embedding's pairs (i, i + d/2) on one rank. The caches' fallback
to the head dim (``kv_layout``) is the one place that contraction is
made: the decode of a split cache (the hybrid's ring too), and the
cross-attention of a few queries over a split cross K/V (reduced
llama-vision's one KV head, llama-vision's eight on 16 ranks); a longer
sequence gathers the cross K/V's dims and runs this rank's heads.

Under sequence parallelism (``cfg.seq_shard``: ``tensor_parallel``'s
mode) the stream between the layers is this rank's slice of the
sequence: norms run on it, attention and the MLP gather it on entry
(``tp.enter``) and reduce-scatter their partial outputs on exit
(``tp.leave``), the embedding hands back a slice and the unembedding
gathers it.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.hier_sync import all_reduce
from repro_torch.core.spans import span
from repro_torch.distributed import tensor_parallel as tp
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
    """The norm of the stream ``x`` (under sequence parallelism its slice,
    so the scale and bias are read through ``tp.seq_leaf``)."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * tp.seq_leaf(params["scale"]).float()).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        y = y * tp.seq_leaf(params["scale"]).float() \
            + tp.seq_leaf(params["bias"]).float()
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
                        sliding_window: int = 0, q_block: int = 512,
                        scale: Optional[float] = None):
    """Online-softmax attention over query blocks.

    q: (b, sq, h, d); k, v: (b, skv, h, d). ``q_offset`` is the absolute
    position of q[0] relative to k[0] (decode: the cache index). Scores are
    f32, ``scale`` q.k (d^-0.5 unless given); masked scores are -1e30. Live
    memory is O(b*h*q_block*skv).
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qf = q.float() * (d ** -0.5 if scale is None else scale)
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
    """GQA self-attention with an optional KV cache, rotary on q and k
    unless ``cfg.nope``, on this model rank's q heads [lo, hi) (every head
    at model size 1): q for them, k and v for the kv heads they read, the
    output projection's rows of those heads, summed over the model group.
    Returns (out, new_cache).

    The cache is this rank's part as ``init_kv_cache`` shapes it
    (``kv_layout``): its kv heads ("kv"); where those do not divide the
    model axis, its part of every head's dims ("hd"); else the whole
    ("whole", always at model size 1). The new cache is a copy with this
    call's keys and values (on "hd" this rank's dims of them) written at
    ``cache_index``. Prefill (``cache_index`` 0) attends over the new
    keys; a later step attends over the cache, on "hd" by contracting
    q . k over the split dims with an all-reduce of the partial scores
    and gathering the output's dims."""
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    n_rep = nq // nkv
    lo, hi = head_bounds(nq)
    klo, khi = lo // n_rep, (hi - 1) // n_rep + 1
    layout = None if cache is None else kv_layout(cfg)
    ka, kz = (0, nkv) if layout in ("hd", "whole") else (klo, khi)
    xc = tp.enter(x)
    b, s, _ = xc.shape

    def proj(w, bias, n, a, z):
        y = xc @ tp.used_part(params[w], -1, n * hd, a * hd, z * hd)
        if bias in params:
            y = y + tp.used_part(params[bias], -1, n * hd, a * hd, z * hd)
        return y.reshape(b, s, z - a, hd)
    q = proj("wq", "bq", nq, lo, hi)
    k = proj("wk", "bk", nkv, ka, kz)
    v = proj("wv", "bv", nkv, ka, kz)
    if not cfg.nope:
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    q_offset, new_cache, out = 0, cache, None
    if cache is not None:
        idx = int(cache_index or 0)
        ck, cv = cache["k"].clone(), cache["v"].clone()
        if layout == "hd":
            d_lo, d_hi = tp.bounds(hd)
            ck[:, idx:idx + s] = k[..., d_lo:d_hi].to(ck.dtype)
            cv[:, idx:idx + s] = v[..., d_lo:d_hi].to(cv.dtype)
        else:
            ck[:, idx:idx + s] = k.to(ck.dtype)
            cv[:, idx:idx + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        if layout == "hd" and idx:
            out = _attend_split_dims(cfg, _gather_heads(q, nq), ck, cv,
                                     idx)[:, :, lo:hi]
        elif layout != "hd":
            k, v, q_offset = ck, cv, idx
    if out is None:
        out = _attend(cfg, q, kv_for_heads(k, lo, hi, n_rep, ka),
                      kv_for_heads(v, lo, hi, n_rep, ka), causal=causal,
                      q_offset=q_offset, flash=cache is None)
    out = out.reshape(b, s, (hi - lo) * hd) @ tp.used_part(
        params["wo"], -2, nq * hd, lo * hd, hi * hd)
    return tp.leave(out), new_cache


def _attend(cfg: ModelConfig, q, k, v, *, causal: bool, q_offset: int,
            flash: bool):
    """q, k, v (b, s, h, d) with as many k / v heads as q heads: the flash
    kernel under ``cfg.use_flash_kernel`` for causal self-attention without
    a cache, else ``blockwise_attention``; the softmax scale is
    ``cfg.attention_multiplier``, or d^-0.5 where that is 0."""
    s = q.shape[1]
    scale = cfg.attention_multiplier or None
    if cfg.use_flash_kernel and flash and causal and s > 1:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=cfg.sliding_window, block_q=min(256, s),
            block_k=min(256, s), scale=scale)
        return out.transpose(1, 2)
    return blockwise_attention(q, k, v, causal=causal, q_offset=q_offset,
                               sliding_window=cfg.sliding_window,
                               scale=scale)


def kv_for_heads(k, lo: int, hi: int, n_rep: int, base: int):
    """k or v (b, s, kv, d) holding kv heads [base, ...) -> one per q head
    of [lo, hi) (q head j reads kv head j // n_rep)."""
    if n_rep == 1 and lo == base and k.shape[2] == hi - lo:
        return k
    if lo % n_rep == 0 and hi % n_rep == 0:
        return _repeat_kv(k[:, :, lo // n_rep - base:hi // n_rep - base],
                          n_rep)
    idx = torch.arange(lo, hi, device=k.device) // n_rep - base
    return k.index_select(2, idx)


def _gather_heads(x, n: int):
    """(b, s, h_r, d) on each model rank, its heads ``tp.bounds(n)`` -> all
    n heads, (b, s, n, d), on every rank (no gradient: decode)."""
    m = tp.size()
    width = -(-n // m)
    lo, hi = tp.bounds(n)
    full = tp.gather_from_model(F.pad(x, (0, 0, 0, width - (hi - lo))), 2)
    idx = [r * width + j for r in range(m)
           for j in range(tp.bounds(n, r)[1] - tp.bounds(n, r)[0])]
    return full[:, :, idx]


def head_bounds(n: int):
    """This rank's heads [lo, hi) of ``n``; a rank without one raises."""
    lo, hi = tp.bounds(n)
    if hi == lo:
        raise NotImplementedError(
            f"{n} heads on a model axis of {tp.size()}: a rank without a "
            "head")
    return lo, hi


def attend_dims(q, k, v, hd: int, mask=None):
    """Attention of q (b, sq, nq, dd) over k, v (b, skv, nkv, dd), each
    this rank's dims of heads of ``hd``: the partial scores summed over
    the model group (forward and backward), ``mask`` (sq, skv) or (skv,)
    keeping where true. -> this rank's dims of every head's output, f32."""
    n_rep = q.shape[2] // k.shape[2]
    kf = _repeat_kv(k, n_rep).float()
    vf = _repeat_kv(v, n_rep).float()
    s = tp.sum_over_model(torch.einsum("bqhd,bkhd->bhqk",
                                       q.float() * hd ** -0.5, kf))
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf)


def head_dims(w, dim: int, n: int, hd: int):
    """The columns (``dim`` -1) or rows (-2) of a whole (.., n * hd, ..)
    projection that hold this rank's dims ``tp.bounds(hd)`` of each of
    its n heads: (.., n * dd, ..)."""
    d_lo, d_hi = tp.bounds(hd)
    if dim == -1:
        return w.reshape(w.shape[0], n, hd)[..., d_lo:d_hi].reshape(
            w.shape[0], -1)
    return w.reshape(n, hd, w.shape[-1])[:, d_lo:d_hi].reshape(
        -1, w.shape[-1])


def _attend_split_dims(cfg: ModelConfig, q, ck, cv, q_offset: int):
    """Causal attention of every head's q (b, s, nq, d) against a cache
    whose head dims are split over the model group (b, S, kv, d / m): the
    partial scores over this rank's dims are summed over the group, the
    output's dims gathered. -> (b, s, nq, d), the same on every rank."""
    sq, hd = q.shape[1], q.shape[-1]
    d_lo, d_hi = tp.bounds(hd)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = torch.arange(ck.shape[1], device=q.device)
    mask = q_pos[:, None] >= kv_pos[None, :]
    if cfg.sliding_window:
        mask &= q_pos[:, None] - kv_pos[None, :] < cfg.sliding_window
    out = attend_dims(q[..., d_lo:d_hi], ck, cv, hd, mask)
    return tp.gather_from_model(out, -1).to(q.dtype)


def cross_attention(attn, cfg: ModelConfig, x, kv):
    """x's queries against precomputed keys and values ``kv`` ({"k", "v"},
    (b, m, kv, hd)): no rope, no mask, never the flash kernel (it is
    causal only). Returns the output projection, (b, s, d_model).

    Under tensor parallelism ``kv`` is this rank's part (``kv_layout``):
    its q heads [lo, hi) attend its kv heads (every kv head where the part
    is whole) and take the output projection's rows of those heads,
    summed over the model group. Where the part is this rank's dims of
    every head, a few queries a row (decode: fewer q heads x queries than
    kv dims, ``_contract_dims``) contract over those dims with the scores
    summed over the group (``attend_dims``); more queries gather the
    dims instead and run this rank's heads, so that the scores of every
    head never stand on one rank."""
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    xc = tp.enter(x)
    b, s, _ = xc.shape
    layout = kv_layout(cfg)
    if layout == "hd" and _contract_dims(cfg, s):
        wq = head_dims(tp.used_part(attn["wq"], -1, nq * hd, 0, nq * hd),
                       -1, nq, hd)
        q = (xc @ wq).reshape(b, s, nq, -1)
        o = attend_dims(q, kv["k"], kv["v"], hd).to(x.dtype)
        wo = head_dims(tp.used_part(attn["wo"], -2, nq * hd, 0, nq * hd),
                       -2, nq, hd)
        return tp.leave(o.reshape(b, s, -1) @ wo)
    if layout == "hd":
        kv = {n: tp.copy_to_model(tp.gather_from_model(t, -1))
              for n, t in kv.items()}
    lo, hi = head_bounds(nq)
    n_rep = nq // nkv
    base = tp.bounds(nkv)[0] if layout == "kv" else 0
    q = (xc @ tp.used_part(attn["wq"], -1, nq * hd, lo * hd, hi * hd)) \
        .reshape(b, s, hi - lo, hd)
    o = blockwise_attention(q, kv_for_heads(kv["k"], lo, hi, n_rep, base),
                            kv_for_heads(kv["v"], lo, hi, n_rep, base),
                            causal=False)
    return tp.leave(o.reshape(b, s, (hi - lo) * hd) @ tp.used_part(
        attn["wo"], -2, nq * hd, lo * hd, hi * hd))


def _contract_dims(cfg: ModelConfig, s: int) -> bool:
    """Whether ``s`` queries a row contract a head-dim-split K/V over its
    dims (the partial scores, s x n_heads a key, cross the model group)
    rather than gather its dims (n_kv_heads x head_dim a key)."""
    return s * cfg.n_heads < cfg.n_kv_heads * cfg.resolved_head_dim


def kv_layout(cfg: ModelConfig) -> str:
    """What a rank holds of a cache's keys and values (and of the cross
    K/V), as ``cache_specs`` splits them: "kv" its kv heads where they
    divide the model axis, else "hd" its part of every head's dims where
    those divide, else "whole"."""
    m = tp.size()
    if m == 1:
        return "whole"
    if cfg.n_kv_heads % m == 0:
        return "kv"
    return "hd" if cfg.resolved_head_dim % m == 0 else "whole"


def kv_part(x, w, cfg: ModelConfig, positions=None):
    """Keys or values ``x @ w`` (b, s, kv, hd), rotated to ``positions``
    when given; under tensor parallelism ``x`` has entered the split
    (``tp.copy_to_model``) and the result is this rank's part of them
    (``kv_layout``), from what it holds of ``w``."""
    b, s, _ = x.shape
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    layout = kv_layout(cfg)
    a, z = tp.bounds(nkv) if layout == "kv" else (0, nkv)
    y = (x @ tp.used_part(w, -1, nkv * hd, a * hd, z * hd)).reshape(
        b, s, z - a, hd)
    if positions is not None:
        y = apply_rope(y, positions, cfg.rope_theta)
    if layout == "hd":
        d_lo, d_hi = tp.bounds(hd)
        y = y[..., d_lo:d_hi]
    return y


def cross_query(attn):
    """The parameters of a cross-attention that ``cross_attention`` reads
    in its layer: all but the wk / wv that ``transformer.stacked_kv`` has
    used once (so that a ZeRO-3 layer hook does not gather them again)."""
    return {k: v for k, v in attn.items() if k not in ("wk", "wv")}


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    """Zero keys and values, (b, max_seq, kv, hd); under tensor
    parallelism this rank's part of them, as ``cache_specs`` splits the
    cache: the kv heads where they divide the model axis, else the head
    dim where it divides, else the whole."""
    kv, hd, m = cfg.n_kv_heads, cfg.resolved_head_dim, tp.size()
    layout = kv_layout(cfg)
    if layout == "kv":
        kv //= m
    elif layout == "hd":
        hd //= m
    shape = (batch, max_seq, kv, hd)
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


def apply_mlp(params, cfg: ModelConfig, x, d_ff: Optional[int] = None):
    """The MLP of hidden width ``d_ff`` (default ``cfg.d_ff``); under
    tensor parallelism, on this rank's columns of it where the leaves are
    split (column- then row-parallel), summed over the model group. Whole
    leaves run on the stream as it is (under sequence parallelism its
    slice, the leaves read through ``tp.seq_leaf``)."""
    if params["wi"].shape[-1] != (d_ff or cfg.d_ff):
        return tp.leave(_mlp(params, tp.enter(x)))
    return _mlp({k: tp.seq_leaf(w) for k, w in params.items()}, x)


def _mlp(params, x):
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


def embed_tokens(params, x, cfg: Optional[ModelConfig] = None):
    """Rows of ``tok`` for the ids ``x``. Under tensor parallelism (``cfg``
    then gives the full widths) from this rank's rows of the vocabulary,
    the ids outside them masked and the lookups summed over the model
    group; or from its columns of d (the specs' fallback), gathered. Under
    sequence parallelism the result is this rank's slice of the
    sequence."""
    tok = params["tok"]
    if tp.size() == 1:
        return tok[x.long()]
    if cfg is None:
        raise ValueError("embed_tokens under tensor parallelism needs cfg")
    if tok.shape[0] != cfg.vocab_padded:
        ids = x.long() - tp.rank() * tok.shape[0]
        inside = (ids >= 0) & (ids < tok.shape[0])
        h = tok[torch.where(inside, ids, 0)].masked_fill(~inside[..., None],
                                                        0)
        return tp.leave(h)
    if tok.shape[1] != cfg.d_model:
        return tp.seq_slice(tp.gather_from_model(tok[x.long()], -1))
    return tp.seq_slice(tok[x.long()])


def unembed(params, cfg: ModelConfig, h):
    """Logits (b, s, V); under tensor parallelism, this rank's columns of
    the vocabulary where ``unembed`` (or a tied ``tok``) is split over it
    (``cross_entropy`` takes them as they are). Under sequence
    parallelism ``h`` is this rank's slice, gathered here."""
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    if tp.size() == 1 or w.shape == (cfg.d_model, cfg.vocab_padded):
        return tp.seq_gather(h) @ w
    if w.shape[1] != cfg.vocab_padded:
        return tp.enter(h) @ w
    lo = tp.rank() * w.shape[0]          # a tied tok split on d
    return tp.reduce_from_model(
        tp.copy_to_model(tp.seq_gather(h))[..., lo:lo + w.shape[0]] @ w)


# (group, n) inside ``global_label_count``
_LABEL_GROUP = None


@contextlib.contextmanager
def global_label_count(group, n: int):
    """Inside the block, ``cross_entropy`` divides its sum by the mean over
    the n ranks of ``group`` of their counts of labels >= 0, not by its
    own: the data-parallel step's ranks, each on its rows of the global
    batch, then sum to the global batch's mean, every token weighted
    alike, as the reference's ``cross_entropy`` over the global batch."""
    global _LABEL_GROUP
    prev, _LABEL_GROUP = _LABEL_GROUP, (group, n)
    try:
        yield
    finally:
        _LABEL_GROUP = prev


def _label_count(valid):
    count = torch.sum(valid)
    if _LABEL_GROUP is None:
        return torch.clamp(count, min=1.0)
    group, n = _LABEL_GROUP
    total = all_reduce(count.detach().clone(), group)
    return torch.clamp(total, min=1.0) / n


def cross_entropy(logits, labels, cfg: ModelConfig, positions=None):
    """Mean next-token CE; masks vocab-padding columns and label == -1.
    Either branch is the span ``loss.cross_entropy`` (``core/spans.py``).

    With ``positions`` (b, k) integer positions of each row, returns
    ``(loss, {"row_loss": (b,), "logits": (b, k, vocab_size)})``: each
    row's mean CE and the f32 logits at its positions, read from the same
    f32 logits the loss is taken from (no second pass over the head)."""
    with span("loss.cross_entropy"):
        return _cross_entropy(logits, labels, cfg, positions)


def _cross_entropy(logits, labels, cfg: ModelConfig, positions=None):
    vp = logits.shape[-1]
    if vp != cfg.vocab_padded:
        return _vocab_parallel_cross_entropy(logits, labels, cfg)
    logits = logits.float()
    if vp > cfg.vocab_size:  # no masked copy when nothing is padded
        col_mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(col_mask, logits, NEG_INF)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = logz - gold
    valid = (labels >= 0).float()
    loss = torch.sum(nll * valid) / _label_count(valid)
    if positions is None:
        return loss
    rows = torch.arange(logits.shape[0], device=logits.device)[:, None]
    row_loss = torch.sum(nll * valid, dim=-1) / torch.clamp(
        torch.sum(valid, dim=-1), min=1.0)
    return loss, {"row_loss": row_loss,
                  "logits": logits[rows, positions.long()][
                      ..., :cfg.vocab_size]}


def _vocab_parallel_cross_entropy(logits, labels, cfg: ModelConfig):
    """``cross_entropy`` of this rank's columns [lo, lo + v) of the
    logits: the max, the sum of exponentials and the gold logit each taken
    over the model group, the padding columns masked by their global
    index; no rank holds the whole (b, s, V)."""
    v = logits.shape[-1]
    lo = tp.rank() * v
    logits = logits.float()
    if lo + v > cfg.vocab_size:
        col = torch.arange(lo, lo + v, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, NEG_INF)
    m = tp.max_over_model(torch.amax(logits, dim=-1))
    logz = m + torch.log(tp.reduce_from_model(
        torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
    ids = torch.clamp(labels, min=0).long() - lo
    inside = (ids >= 0) & (ids < v)
    gold = torch.gather(logits, -1, torch.where(inside, ids, 0)[..., None])
    gold = tp.reduce_from_model(torch.where(inside, gold[..., 0], 0.0))
    valid = (labels >= 0).float()
    return torch.sum((logz - gold) * valid) / _label_count(valid)
