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
