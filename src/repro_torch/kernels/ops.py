"""Public kernel entry points with the reference's signatures and padding
rules (port of the JAX package's ``kernels/ops.py``): pad to block
multiples, run the kernel wrapper, slice back. Each wrapper launches its
CUDA kernel on a CUDA tensor and runs its plain version on a CPU tensor."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import hier_agg as _hier
from repro_torch.kernels import ssd_scan as _ssd


def _pad_to(x, dim: int, mult: int):
    pad = (-x.shape[dim]) % mult
    if not pad:
        return x, 0
    return F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [0, pad]), pad


def aggregate_shards(shards, *, block: int = 8 * 1024):
    """(n_workers, L) -> (L,) mean — the paper's shard-aggregator step."""
    n, L = shards.shape
    block = min(block, max(128, L))
    x, _ = _pad_to(shards, 1, block)
    return _hier.aggregate_shards(x)[:L]


def aggregate_and_apply(shards, param, *, lr: float, block: int = 8 * 1024):
    n, L = shards.shape
    block = min(block, max(128, L))
    x, _ = _pad_to(shards, 1, block)
    p, _ = _pad_to(param, 0, block)
    return _hier.aggregate_and_apply(x, p, lr)[:L]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 256, block_k: int = 256):
    """(b, h, s, d) attention; pads seq to block multiples. Differentiable:
    kernel forward + kernel backward (``FlashAttention``: the forward saves
    its logsumexp when an input wants a gradient; ``flash_attention_bwd``
    computes the reference's vjp, ``ops.py:48-79``, with kernels)."""
    sq, sk = q.shape[2], k.shape[2]
    block_q = min(block_q, max(16, sq))
    block_k = min(block_k, max(16, sk))
    qp, _ = _pad_to(q, 2, block_q)
    kp, pk = _pad_to(k, 2, block_k)
    vp, _ = _pad_to(v, 2, block_k)
    if pk and not causal:
        # padded keys would be visible without the causal mask
        raise NotImplementedError(
            "non-causal flash with padded kv not supported; pad inputs")
    out = _flash.FlashAttention.apply(qp, kp, vp, causal, window)
    return out[:, :, :sq]


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256):
    """Mamba2 SSD over (b, s, h, p); pads seq to the chunk multiple (padded
    dt = 0 leaves the state unchanged, so the final state needs no
    slicing)."""
    s = x.shape[1]
    chunk = min(chunk, max(16, s))
    xp, _ = _pad_to(x, 1, chunk)
    dtp, _ = _pad_to(dt, 1, chunk)
    Bp, _ = _pad_to(B, 1, chunk)
    Cp, _ = _pad_to(C, 1, chunk)
    y, final = _ssd.ssd_scan(xp, dtp, A, Bp, Cp, D, chunk=chunk)
    return y[:, :s], final
