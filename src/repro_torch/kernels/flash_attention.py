"""Causal / sliding-window attention forward with an online softmax.

``flash_attention`` replaces the Pallas kernel
``src/repro/kernels/flash_attention.py::_flash_kernel`` with one of two CUDA
kernels, chosen by dtype alone (``flash_route``):

 - bf16 -> ``"wgmma"``: ``csrc/flash_attention_wgmma.cu``, Hopper's tensor
   cores (``wgmma``, bf16 in, f32 accumulate) fed by TMA through a
   two-stage K/V ring;
 - f32 -> ``"cuda_cores"``: ``csrc/flash_attention.cu``, f32 FMAs on the
   CUDA cores. On the tensor cores f32 would run as TF32, which cannot
   hold the f32 tolerance (2e-4 / 2e-5).

On an H100 the function is bound by operations: 4 * b * h * d * s^2 / 2
causal FLOPs against the 989 TFLOP/s bf16 tensor-core rate.

Head dims: 32, 64, 112 and 128 (``HEAD_DIMS``), every head dim of the
configurations in ``configs`` and of their reduced forms. The tensor-core
kernel runs d = 112 (zamba2-7b's 3584 / 32) on its d = 128 instance,
reading the true 112 columns through TMA (the rest arrive as zeros) and
storing 112; the CUDA-core kernel has a d = 112 instance. Neither pads a
copy.

Both kernels read q, k and v as strided (b, h, s, d) views with d
contiguous (the tensor-core route also needs 16-byte aligned bases and
strides, for TMA) and write the output in (b, s, h, d) memory order,
returned as its (b, h, s, d) view: the model's transposed views go in and
come out with no copy. A view the kernels cannot read raises; nothing is
copied silently.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel or
raises. ``FlashAttention`` is the differentiable form: the kernel forward
and, as in the reference (``ops.py:48-79``), a backward that is the
gradient of the plain blockwise attention, recomputed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches of flash_attention (plain calls not counted)
ROUTE_LAUNCHES = {"wgmma": 0, "cuda_cores": 0}  # the same launches by route

HEAD_DIMS = (32, 64, 112, 128)
WGMMA_BK = 128  # keys per tile of the tensor-core kernel (BK in its source)
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


def flash_route(dtype: torch.dtype, d: int) -> str:
    """Which kernel takes (dtype, head dim d in ``HEAD_DIMS``): bf16 the
    tensor cores ("wgmma"), f32 the CUDA cores ("cuda_cores"). Raises on
    anything else."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_cores"
    raise TypeError(f"flash_attention takes f32 or bf16, got {dtype}")


def kernel_strides(x: torch.Tensor, route: str) -> list[int]:
    """The element strides of every dim but the last through which a
    kernel reads ``x``: (b, h, s) of flash's (b, h, s, d), (b, s, h) of the
    SSD scan's x and (b, s) of its B and C. The last dim must be
    contiguous; a tensor-core ("wgmma") route also needs a 16-byte aligned
    base and 16-byte multiple strides (TMA). A size-1 dim never moves the
    address, so its stride is replaced by the tensor's extent rounded up
    to 8, which satisfies both. Raises on a view the kernel cannot
    read."""
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError(f"the last dim must be contiguous, got strides "
                         f"{x.stride()}")
    extent = 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
    extent = -(-extent // 8) * 8
    strides = [st if n > 1 else extent
               for n, st in zip(x.shape[:-1], x.stride()[:-1])]
    if route == "wgmma":
        nbytes = x.element_size()
        if x.data_ptr() % 16 or any(st * nbytes % 16 for st in strides):
            raise ValueError(
                f"the tensor-core route reads through TMA: base "
                f"{x.data_ptr():#x} and strides {x.stride()} (x {nbytes} "
                "bytes) must be multiples of 16 bytes")
    return strides


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (b, h, sq, d); k, v: (b, h, sk, d) -> (b, h, sq, d). Forward only.
    On a CUDA tensor the result is a (b, h, sq, d) view of (b, sq, h, d)
    memory."""
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, causal=causal, window=window)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (b, h, s, d) with equal "
                         "b, h, d and k.shape == v.shape")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    route = flash_route(q.dtype, d)
    strides = [s for x in (q, k, v) for s in kernel_strides(x, route)]
    global LAUNCHES
    lib = _build.load()
    out = torch.empty(b, sq, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides += kernel_strides(out, "cuda_cores")
    st = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):        # the launch's current device
        stream = torch.cuda.current_stream().cuda_stream
        fn = (lib.smlt_flash_attention_fwd_wgmma if route == "wgmma"
              else lib.smlt_flash_attention_fwd)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 h, sq, sk, d, int(causal), int(window), d ** -0.5, st,
                 stream)
    _build.check(err, f"flash_attention ({route})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def wgmma_tile(a, b, which: str):
    """One tile of the tensor-core kernel's products, for the card tests
    (counts no launch), with n = WGMMA_BK keys and d in ``HEAD_DIMS`` (112
    through the d = 128 instance, as in the kernel): ``"qk"``: a (64, d) @
    b (n, d)^T -> (64, n); ``"pv"``: a (64, n) @ b (n, d) -> (64, d); bf16
    in, f32 out, both contiguous."""
    d, n = b.shape[1], WGMMA_BK
    want = {"qk": ((64, d), (n, d), (64, n)),
            "pv": ((64, n), (n, d), (64, d))}[which]
    if (tuple(a.shape), tuple(b.shape)) != want[:2] or d not in HEAD_DIMS:
        raise ValueError(f"{which} tile wants {want[:2]}, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError("wgmma_tile takes bf16")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(want[2], dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.load().smlt_wgmma_tile(
            int(which == "pv"), a.data_ptr(), b.data_ptr(), out.data_ptr(), d,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"smlt_wgmma_tile ({which})")
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
