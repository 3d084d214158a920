"""Causal / sliding-window attention forward with an online softmax.

``flash_attention`` replaces the Pallas kernel
``src/repro/kernels/flash_attention.py::_flash_kernel`` with the CUDA
kernel in ``csrc/flash_attention.cu``. On an H100 it is bound by
operations: 4 * b * h * d * s^2 / 2 causal FLOPs against the 989 TFLOP/s
bf16 tensor-core rate. This first kernel computes on the CUDA cores in f32
(shared-memory K/V tiles, register-tiled scores and accumulators, only the
k-tiles the mask leaves), so it is far from that bound; ``wgmma`` and TMA
are for a later kernel.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``FlashAttention`` is the differentiable form: the kernel forward
and, as in the reference (``ops.py:48-79``), a backward that is the
gradient of the plain blockwise attention, recomputed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches of flash_attention (plain calls not counted)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
NEG_INF = -1e30


def plain_flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """The same function in plain PyTorch, 256 queries at a time:
    f32 scores of q * d^-0.5 against k, -1e30 where masked, then
    (exp(s - max) @ v) / max(sum exp(s - max), 1e-30). (b, h, s, d)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kf = k.float()
    vf = v.float()
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for start in range(0, sq, 256):
        qb = q[:, :, start:start + 256].float() * d ** -0.5
        qpos = start + torch.arange(qb.shape[2], device=q.device)
        s = qb @ kf.transpose(-1, -2)
        mask = torch.ones(qb.shape[2], sk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        outs.append((p @ vf) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30))
    return torch.cat(outs, dim=2).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (b, h, sq, d); k, v: (b, h, sk, d) -> (b, h, sq, d). Forward only."""
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, causal=causal, window=window)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (b, h, s, d) with equal "
                         "b, h, d and k.shape == v.shape")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    global LAUNCHES
    lib = _build.load()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):        # the launch's current device
        err = lib.smlt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            sq, sk, d, int(causal), int(window), d ** -0.5, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "smlt_flash_attention_fwd")
    LAUNCHES += 1
    return out


def _blockwise_bhsd(q, k, v, causal: bool, window: int):
    """The model's blockwise attention in (b, h, s, d) layout."""
    from repro_torch.models.layers import blockwise_attention
    out = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              sliding_window=window)
    return out.transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """Kernel forward; the backward recomputes the plain blockwise
    attention under autograd and returns its gradients (O(block x s)
    memory; a backward kernel is later work)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = _blockwise_bhsd(*xs, ctx.causal, ctx.window)
            dq, dk, dv = torch.autograd.grad(out, xs, g)
        return dq, dk, dv, None, None
