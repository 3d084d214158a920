"""Mamba2 SSD chunked scan, forward: y and the final state.

``ssd_scan`` replaces the Pallas kernel
``src/repro/kernels/ssd_scan.py::_ssd_kernel`` with the CUDA kernel in
``csrc/ssd_scan.cu``. On an H100, at mamba2-2.7b's scoring shape, its byte
bound and its bf16 tensor-core bound are both near 0.11 ms; this first
kernel computes on the CUDA cores in f32 (one block per (batch, head)
walking its chunks with the state in shared memory, 64-row tiles, only the
tiles the causal mask leaves), so operations bound it, far above that.

The model path hands it mixed dtypes: x, B and C in the model dtype, dt
and A in f32, D a model-dtype parameter. The wrapper upcasts dt, A and D
(small) to f32, never downcasts, and takes x, B and C in one dtype.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. There is no backward: like the reference, which cannot
differentiate its Pallas kernel, the wrapper refuses inputs that require
grad on a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches of ssd_scan (plain calls not counted)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEADDIM = 64
MAX_STATE = 256


def plain_ssd_scan(x, dt, A, B, C, D, chunk: int):
    """The Pallas kernel's function in plain PyTorch, one chunk at a time
    from a zero state. x: (b, s, h, p)  dt: (b, s, h)  A, D: (h,)
    B, C: (b, s, n); s a multiple of ``chunk``. Returns (y in x's dtype,
    final state (b, h, n, p) in f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"s = {s} is not a multiple of chunk = {chunk}")
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf, Df = B.float(), C.float(), D.float()
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    S = torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        xc, dtc = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]
        Bc, Cc = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]
        seg = torch.cumsum(dtc * Af, dim=1)                      # (b, Q, h)
        xdt = xc * dtc[..., None]
        CB = Cc @ Bc.transpose(1, 2)                             # (b, Q, Q)
        # mask the exponent before exp: for i < j, seg_i - seg_j > 0
        diff = torch.where(causal, seg[:, :, None, :] - seg[:, None, :, :],
                           -torch.inf)
        y = torch.einsum("bijh,bjhp->bihp", CB[..., None] * torch.exp(diff),
                         xdt)
        y = y + torch.exp(seg)[..., None] * torch.einsum(
            "bin,bhnp->bihp", Cc, S)
        seg_last = seg[:, -1]                                    # (b, h)
        S = S * torch.exp(seg_last)[:, :, None, None] + torch.einsum(
            "bjn,bjhp->bhnp", Bc,
            xdt * torch.exp(seg_last[:, None] - seg)[..., None])
        ys.append(y + Df[None, None, :, None] * xc)
    return torch.cat(ys, dim=1).to(x.dtype), S


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256):
    """x: (b, s, h, p)  dt: (b, s, h)  A, D: (h,)  B, C: (b, s, n)
    -> (y: (b, s, h, p) in x's dtype, final_state: (b, h, n, p) f32).
    s must be a multiple of ``chunk`` (``ops.ssd_scan`` pads)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if (dt.shape != (b, s, h) or A.shape != (h,) or D.shape != (h,)
            or B.shape != (b, s, n) or C.shape != (b, s, n)):
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}, D {tuple(D.shape)}: "
            "want (b, s, h, p), (b, s, h), (h,), (b, s, n), (b, s, n), (h,)")
    if chunk < 1 or s % chunk:
        raise ValueError(f"s = {s} is not a multiple of chunk = {chunk}")
    if x.device.type == "cpu":
        return plain_ssd_scan(x, dt, A, B, C, D, chunk)
    if any(t.requires_grad for t in (x, dt, A, B, C, D)):
        raise RuntimeError(
            "ssd_scan has no backward: the kernel cannot be differentiated "
            "(neither can the reference's); use the plain ssd_chunked path "
            "for gradients")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes f32 or bf16 x, B, C of one dtype, "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if p > MAX_HEADDIM or n > MAX_STATE:
        raise ValueError(f"head dim {p} > {MAX_HEADDIM} or state {n} > "
                         f"{MAX_STATE}")
    global LAUNCHES
    lib = _build.load()
    x, dt = x.contiguous(), dt.float().contiguous()
    A, D = A.float().contiguous(), D.float().contiguous()
    B = B if B.stride(-1) == 1 else B.contiguous()
    C = C if C.stride(-1) == 1 else C.contiguous()
    y = torch.empty_like(x)
    final = torch.empty(b, h, n, p, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):        # the launch's current device
        err = lib.smlt_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), final.data_ptr(),
            b, s, h, p, n, chunk, B.stride(0), B.stride(1), C.stride(0),
            C.stride(1), _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "smlt_ssd_scan")
    LAUNCHES += 1
    return y, final
