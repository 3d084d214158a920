"""Mamba2 / SSD (state-space duality) language model [arXiv:2405.21060];
port of the JAX package's ``models/mamba2.py``.

The SSD forward pass is the chunked "dual" form: intra-chunk work is a
masked attention-like matmul (quadratic in the chunk length only),
inter-chunk work is a linear recurrence over per-chunk states. Decode is
the O(1)-per-token recurrent form.

Without a cache and under ``cfg.use_ssd_kernel`` the block runs the
hand-written SSD kernel (``kernels.ops.ssd_scan``); otherwise
``ssd_chunked`` below, which also takes a carried state. Layers are stacked
on a leading axis as in the reference and unbound once per forward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import remat_wrap, run_layers, stack_init

# ---------------------------------------------------------------------------
# causal depthwise conv1d
# ---------------------------------------------------------------------------


def causal_conv(x, w, state=None, bias=None):
    """x: (b, s, c); w: (W, c) depthwise. state: (b, W-1, c) carried inputs.
    Returns (silu(out + bias), new_state), the bias (c,) only where given.
    The sum of W shifted products in x's dtype, in the reference's order
    (not ``F.conv1d``, whose f32 path may run in TF32 and sums in another
    order)."""
    W = w.shape[0]
    s = x.shape[1]
    if state is None:
        state = torch.zeros(x.shape[0], W - 1, x.shape[2], dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = w[0] * xp[:, 0:s]
    for i in range(1, W):
        out = out + w[i] * xp[:, i:i + s]
    if bias is not None:
        out = out + bias
    return F.silu(out), xp[:, -(W - 1):].clone()


# ---------------------------------------------------------------------------
# SSD core (chunked dual form)
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, B, C, D, chunk: int, initial_state=None):
    """x: (b,s,h,p)  dt: (b,s,h) (post-softplus)  A: (h,) (negative)
    B, C: (b,s,n)  D: (h,). Returns (y: (b,s,h,p), final_state: (b,h,n,p))."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    Af = A.float()
    S = initial_state if initial_state is not None else torch.zeros(
        b, h, n, p, dtype=torch.float32, device=x.device)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    ys = []
    for c0 in range(0, s + pad, chunk):
        x_c, dt_c = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]
        B_c, C_c = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]
        seg = torch.cumsum(dt_c * Af, dim=1)                     # (b,Q,h)
        xdt = x_c * dt_c[..., None]
        # intra-chunk: attention-like masked matmul
        CB = torch.einsum("bin,bjn->bij", C_c, B_c)
        # mask the exponent BEFORE exp: for i<j, seg_i - seg_j > 0 overflows
        diff = torch.where(causal, seg[:, :, None, :] - seg[:, None, :, :],
                           -torch.inf)
        scores = CB[..., None] * torch.exp(diff)                 # (b,Q,Q,h)
        y = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        # inter-chunk: contribution of the carried state
        y = y + torch.einsum("bin,bhnp->bihp", C_c, S) * \
            torch.exp(seg)[..., None]
        # state update
        seg_last = seg[:, -1, :]                                 # (b,h)
        Bx = torch.einsum("bjn,bjhp->bhnp", B_c,
                          xdt * torch.exp(seg_last[:, None] - seg)[..., None])
        S = S * torch.exp(seg_last)[:, :, None, None] + Bx
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), S


def ssd_decode_step(S, x, dt, A, B, C, D):
    """One-token recurrence. x: (b,h,p)  dt: (b,h)  B, C: (b,n)  S: (b,h,n,p)."""
    xf, dtf = x.float(), dt.float()
    dA = torch.exp(dtf * A.float())                              # (b,h)
    Bx = torch.einsum("bn,bhp->bhnp", B.float(), xf * dtf[..., None])
    S = S * dA[..., None, None] + Bx
    y = torch.einsum("bn,bhnp->bhp", C.float(), S)
    y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), S


# ---------------------------------------------------------------------------
# mamba2 block
# ---------------------------------------------------------------------------


def init_mamba_block(normal, cfg: ModelConfig, device,
                     d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    di, nh, n = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_state
    W = cfg.ssm_conv_width
    dt = cfg.dtype
    # U(1, 16) for A_log, through the normal CDF of one draw per head
    u = 0.5 * (1.0 + torch.erf(normal((nh,)) / math.sqrt(2.0)))
    bias = {"conv_x_bias": torch.zeros(di, dtype=dt, device=device),
            "conv_BC_bias": torch.zeros(2 * n, dtype=dt, device=device)
            } if cfg.ssm_conv_bias else {}
    return {**bias,
        "ln": {"scale": torch.ones(d, dtype=dt, device=device)},
        "wz": L.dense_init(normal, d, di, dt),
        "wx": L.dense_init(normal, d, di, dt),
        "wB": L.dense_init(normal, d, n, dt),
        "wC": L.dense_init(normal, d, n, dt),
        "wdt": L.dense_init(normal, d, nh, dt),
        "dt_bias": torch.zeros(nh, dtype=dt, device=device),
        "A_log": torch.log(1.0 + 15.0 * u).to(dt),
        "D": torch.ones(nh, dtype=dt, device=device),
        "conv_x": (normal((W, di)) * W ** -0.5).to(dt),
        "conv_BC": (normal((W, 2 * n)) * W ** -0.5).to(dt),
        "gate_ln": {"scale": torch.ones(di, dtype=dt, device=device)},
        "wo": L.dense_init(normal, di, d, dt),
    }


def _split(bp, cfg: ModelConfig) -> bool:
    """Whether this block holds its model part of the heads (tensor
    parallelism: ``wz``/``wx``/``wdt``, ``conv_x``, ``dt_bias``, ``A_log``,
    ``D``, ``gate_ln`` split by heads, ``wB``/``wC``/``conv_BC`` whole,
    ``wo`` split by rows)."""
    if tp.size() == 1 or bp["wx"].shape[-1] == cfg.d_inner:
        return False
    if cfg.ssm_nheads % tp.size():
        raise NotImplementedError(
            f"{cfg.ssm_nheads} SSM heads on a model axis of {tp.size()}: "
            "the specs split d_inner inside a head")
    return True


def _in_proj(bp, cfg: ModelConfig, h, split: bool = False):
    """The input projections. Under tensor parallelism (``split``) z, x
    and dt are this rank's heads' columns, and B, C whole. Under sequence
    parallelism ``h`` is this rank's slice: the norm runs on it, and the
    projections (B and C too, which only this rank's heads then read, so
    their gradient is a partial sum: ``tp.seq_leaf`` reads them, the norm's
    scale and ``conv_BC``) on the gathered sequence."""
    hin = L.rmsnorm_raw(h, tp.seq_leaf(bp["ln"]["scale"]))
    hc = tp.enter(hin) if split else hin
    z = hc @ bp["wz"]
    x = hc @ bp["wx"]
    hbc = hc if tp.seq_parallel() else hin
    BC = torch.cat([hbc @ tp.seq_leaf(bp["wB"]),
                    hbc @ tp.seq_leaf(bp["wC"])], dim=-1)
    dt = F.softplus((hc @ bp["wdt"]).float() + bp["dt_bias"].float())
    A = -torch.exp(bp["A_log"].float())
    return z, x, BC, dt, A


def _gated_norm(y, z, scale, cfg: ModelConfig, split: bool):
    """rmsnorm(y * silu(z)) over d_inner; under tensor parallelism y and z
    are this rank's columns and the sum of squares is summed over the
    model group."""
    if not split:
        return L.rmsnorm_raw(y * F.silu(z), scale)
    g = (y * F.silu(z)).float()
    ms = tp.sum_over_model(torch.sum(g * g, dim=-1, keepdim=True)) \
        / cfg.d_inner
    return (g * torch.rsqrt(ms + 1e-5) * scale.float()).to(y.dtype)


def _out_proj(bp, y, split: bool):
    out = y @ bp["wo"]
    return tp.leave(out) if split else out


def apply_mamba_block(bp, cfg: ModelConfig, h, cache=None):
    """cache: {"conv_x", "conv_BC", "ssm"} or None. Returns (h + the
    mixer's output, new_cache)."""
    out, new_cache = mamba_mixer(bp, cfg, h, cache)
    return h + out, new_cache


def mamba_mixer(bp, cfg: ModelConfig, h, cache=None):
    """The block without its residual add: the norm of ``h``, the input
    projections, the convolutions (with their biases under
    ``cfg.ssm_conv_bias``), the SSD layer, the gated norm and the output
    projection. Returns (out, new_cache); a model whose residual branch is
    scaled (granite-4.0-h's ``residual_multiplier``) adds it itself."""
    split = _split(bp, cfg)
    nh, p, n = bp["A_log"].shape[-1], cfg.ssm_headdim, cfg.ssm_state
    z, x, BC, dt, A = _in_proj(bp, cfg, h, split)
    b, s, _ = x.shape
    cx = cache["conv_x"] if cache is not None else None
    cbc = cache["conv_BC"] if cache is not None else None
    x, new_cx = causal_conv(x, bp["conv_x"], cx, bp.get("conv_x_bias"))
    BC, new_cbc = causal_conv(BC, tp.seq_leaf(bp["conv_BC"]), cbc,
                              bp.get("conv_BC_bias"))
    if split and not tp.seq_parallel():  # whole B, C read by this rank's
        BC = tp.copy_to_model(BC)        # heads only
    B, C = torch.split(BC, n, dim=-1)

    x = x.reshape(b, s, nh, p)
    if cfg.use_ssd_kernel and cache is None:
        # the SSD chunk-scan kernel (scoring / prefill-from-scratch path)
        from repro_torch.kernels import ops as kops
        y, S = kops.ssd_scan(x, dt, A, B, C, bp["D"],
                             chunk=min(cfg.ssm_chunk, s))
    else:
        s0 = cache["ssm"] if cache is not None else None
        y, S = ssd_chunked(x, dt, A, B, C, bp["D"], cfg.ssm_chunk,
                           initial_state=s0)
    y = y.reshape(b, s, nh * p)
    y = _gated_norm(y, z, bp["gate_ln"]["scale"], cfg, split)
    return _out_proj(bp, y, split), {"conv_x": new_cx, "conv_BC": new_cbc,
                                     "ssm": S}


def apply_mamba_decode(bp, cfg: ModelConfig, h, cache):
    """Single-token path (s == 1) using the recurrent form."""
    b = h.shape[0]
    split = _split(bp, cfg)
    nh, p, n = bp["A_log"].shape[-1], cfg.ssm_headdim, cfg.ssm_state
    z, x, BC, dt, A = _in_proj(bp, cfg, h, split)
    x, new_cx = causal_conv(x, bp["conv_x"], cache["conv_x"],
                            bp.get("conv_x_bias"))
    BC, new_cbc = causal_conv(BC, bp["conv_BC"], cache["conv_BC"],
                              bp.get("conv_BC_bias"))
    B, C = torch.split(BC, n, dim=-1)
    y, S = ssd_decode_step(cache["ssm"], x[:, 0].reshape(b, nh, p),
                           dt[:, 0], A, B[:, 0], C[:, 0], bp["D"])
    y = y.reshape(b, 1, nh * p)
    y = _gated_norm(y, z, bp["gate_ln"]["scale"], cfg, split)
    return h + _out_proj(bp, y, split), {"conv_x": new_cx,
                                         "conv_BC": new_cbc, "ssm": S}


def init_block_cache(cfg: ModelConfig, batch: int, device):
    """Zero conv and SSM states; under tensor parallelism this rank's
    heads' part (``cache_specs``: ``ssm`` on its heads, ``conv_x`` on its
    columns of d_inner, ``conv_BC`` whole)."""
    W, di, n = cfg.ssm_conv_width, cfg.d_inner, cfg.ssm_state
    nh, m = cfg.ssm_nheads, tp.size()
    if nh % m == 0:
        nh, di = nh // m, di // m
    return {
        "conv_x": torch.zeros(batch, W - 1, di, dtype=cfg.dtype,
                              device=device),
        "conv_BC": torch.zeros(batch, W - 1, 2 * n, dtype=cfg.dtype,
                               device=device),
        "ssm": torch.zeros(batch, nh, n, cfg.ssm_headdim,
                           dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def init(normal, cfg: ModelConfig, device):
    return {
        "embed": L.init_embed(normal, cfg),
        "blocks": stack_init(lambda: init_mamba_block(normal, cfg, device),
                             cfg.n_layers),
        "final_norm": L.init_norm(cfg, device),
    }


def forward(params, cfg: ModelConfig, tokens, *, cache=None, decode=False):
    """Returns (logits, new cache stacked on the layer axis, or None when
    no cache was given)."""
    def apply(h, bp, c):
        if decode:
            return apply_mamba_decode(bp, cfg, h, c)
        return apply_mamba_block(bp, cfg, h, cache=c)

    h = L.embed_tokens(params["embed"], tokens, cfg)
    h, new_cache = run_layers(h, params["blocks"], cache, cfg.n_layers,
                              remat_wrap(cfg, apply))
    h = L.apply_norm(params["final_norm"], cfg, h)
    return L.unembed(params["embed"], cfg, h), new_cache


def loss_fn(params, cfg: ModelConfig, batch):
    logits, _ = forward(params, cfg, batch["tokens"])
    return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:], cfg)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int = 0,
               device="cuda"):
    """Zero conv and SSM states stacked on the layer axis (an SSM cache does
    not grow with the sequence, so ``max_seq`` is unused)."""
    c = init_block_cache(cfg, batch, device)
    return {k: torch.zeros((cfg.n_layers,) + x.shape, dtype=x.dtype,
                           device=x.device) for k, x in c.items()}


def prefill(params, cfg: ModelConfig, tokens, max_seq: Optional[int] = None):
    cache = init_cache(cfg, tokens.shape[0], device=tokens.device)
    return forward(params, cfg, tokens, cache=cache)


def decode_step(params, cfg: ModelConfig, cache, pos, tokens):
    """tokens: (b, 1); ``pos`` is unused (the state carries the position)."""
    return forward(params, cfg, tokens, cache=cache, decode=True)
