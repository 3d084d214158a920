"""Plain PyTorch oracles for the kernels (port of the JAX package's
``kernels/ref.py``): naive forms, not the blockwise algorithms the kernels
use, so agreement is a real check."""
from __future__ import annotations

import torch


def ref_aggregate(shards):
    """(n, L) -> (L,) mean in f32."""
    return torch.mean(shards.float(), dim=0).to(shards.dtype)


def ref_aggregate_apply(shards, param, lr: float):
    g = torch.mean(shards.float(), dim=0)
    return (param.float() - lr * g).to(param.dtype)


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive full-softmax attention. q: (b, h, sq, d), k/v: (b, h, sk, d)."""
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ref_ssd(x, dt, A, B, C, D):
    """Sequential (per-token) SSD recurrence — the O(s) definition.
    x: (b, s, h, p)  dt: (b, s, h)  A, D: (h,)  B, C: (b, s, n)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B.float(), C.float()
    S = torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt, dtt, Bt, Ct = xf[:, t], dtf[:, t], Bf[:, t], Cf[:, t]
        dA = torch.exp(dtt * Af)                                  # (b, h)
        S = S * dA[..., None, None] + torch.einsum(
            "bn,bhp->bhnp", Bt, xt * dtt[..., None])
        ys.append(torch.einsum("bn,bhnp->bhp", Ct, S))
    y = torch.stack(ys, dim=1) + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), S
