"""Mamba2 SSD chunked scan, forward: y and the final state.

``ssd_scan`` replaces the Pallas kernel
``src/repro/kernels/ssd_scan.py::_ssd_kernel`` with one of two CUDA
kernels, chosen by ``ssd_route`` from the dtype and the shape:

 - bf16 with p a multiple of 16 up to 64, n a multiple of 16 up to 128 and
   a chunk that is a multiple of 64 up to 256 -> ``"wgmma"``:
   ``csrc/ssd_scan_wgmma.cu``, Hopper's tensor cores (``wgmma``, bf16 in,
   f32 accumulate) fed by TMA, with the f32 operands (the decayed scores,
   the carried state, the decayed B) split into two bf16 products each so
   that y and the state hold the reference's bf16 tolerances;
 - every other bf16 shape (the reference's sweep: n 8, p 16, chunk 16 or
   32; n up to 256) and all f32 -> ``"cuda_cores"``: ``csrc/ssd_scan.cu``,
   f32 on the CUDA cores (one block per (batch, head) walking its chunks
   with the state in shared memory). On the tensor cores f32 would run as
   TF32, which cannot hold the f32 tolerance (2e-4).

On an H100, at mamba2-2.7b's scoring shape, the function is bound by bytes
(about 0.11 ms). The tensor-core route reads x, B and C through TMA maps of
the model's own views (B and C the two halves of one (b, s, 2n) tensor),
so a view whose base or strides are not multiples of 16 bytes raises.

The model path hands it mixed dtypes: x, B and C in the model dtype, dt
and A in f32, D a model-dtype parameter. The wrapper upcasts dt, A and D
(small) to f32, never downcasts, and takes x, B and C in one dtype.

A CPU tensor takes the plain version, a CUDA tensor launches a kernel or
raises; under a dispatch mode or on a fake tensor the call goes through
the custom op ``smlt::ssd_scan`` (``flash_attention.traced``), whose fake
version gives the kernel's outputs with no launch and whose
``FlopCounterMode`` formula is ``ssd_flops``. There is no backward:
like the reference, which cannot differentiate its Pallas kernel, the
wrapper refuses inputs that require grad on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel_strides, traced

LAUNCHES = 0  # kernel launches of ssd_scan (plain calls not counted)
ROUTE_LAUNCHES = {"wgmma": 0, "cuda_cores": 0}  # the same launches by route

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEADDIM = 64
MAX_STATE = 256
WGMMA_NPAD = 128          # NPAD in csrc/ssd_scan_wgmma.cu: the largest n
WGMMA_MAX_CHUNK = 256     # MAX_TILES * TILE there


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


def ssd_route(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """Which kernel takes x of ``dtype`` with head dim p, state n and the
    chunk: "wgmma" (the tensor cores) for bf16 with p % 16 == 0, p <= 64,
    n % 16 == 0, n <= 128 and chunk % 64 == 0, chunk <= 256; "cuda_cores"
    for every other bf16 shape and for f32. Raises on any other dtype."""
    if dtype == torch.float32:
        return "cuda_cores"
    if dtype != torch.bfloat16:
        raise TypeError(f"ssd_scan takes f32 or bf16, got {dtype}")
    if (p % 16 == 0 and p <= MAX_HEADDIM and n % 16 == 0
            and n <= WGMMA_NPAD and chunk % 64 == 0
            and chunk <= WGMMA_MAX_CHUNK):
        return "wgmma"
    return "cuda_cores"


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256, route=None):
    """x: (b, s, h, p)  dt: (b, s, h)  A, D: (h,)  B, C: (b, s, n)
    -> (y: (b, s, h, p) in x's dtype, final_state: (b, h, n, p) f32).
    s must be a multiple of ``chunk`` (``ops.ssd_scan`` pads). ``route``
    ("wgmma" or "cuda_cores") overrides ``ssd_route`` on a CUDA tensor, for
    the card checks; a shape the named kernel does not take raises."""
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
    if route not in (None, "wgmma", "cuda_cores"):
        raise ValueError(f"route {route!r}: want 'wgmma' or 'cuda_cores'")
    if x.device.type != "cpu" and any(
            t.requires_grad for t in (x, dt, A, B, C, D)):
        raise RuntimeError(
            "ssd_scan has no backward: the kernel cannot be differentiated "
            "(neither can the reference's); use the plain ssd_chunked path "
            "for gradients")
    if traced(x):
        return torch.ops.smlt.ssd_scan(x, dt, A, B, C, D, chunk, route)
    return _ssd_impl(x, dt, A, B, C, D, chunk, route)


def _check_kernel_inputs(x, B, C, p: int, n: int):
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes f32 or bf16 x, B, C of one dtype, "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if p > MAX_HEADDIM or n > MAX_STATE:
        raise ValueError(f"head dim {p} > {MAX_HEADDIM} or state {n} > "
                         f"{MAX_STATE}")


def _ssd_impl(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, chunk: int,
              route: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op on real tensors: the plain version on the CPU, a launch on
    any other device."""
    if x.device.type == "cpu":
        return plain_ssd_scan(x, dt, A, B, C, D, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    _check_kernel_inputs(x, B, C, p, n)
    best = ssd_route(x.dtype, p, n, chunk)
    if route == "wgmma" and best != "wgmma":
        raise ValueError(f"the wgmma route does not take {x.dtype} with p "
                         f"{p}, n {n}, chunk {chunk}")
    route = route or best
    global LAUNCHES
    dt = dt.float().contiguous()
    A, D = A.float().contiguous(), D.float().contiguous()
    if route == "wgmma":             # TMA reads the views in place
        st = (ctypes.c_longlong * 7)(*[
            s_ for t in (x, B, C) for s_ in kernel_strides(t, "wgmma")])
    else:
        x = x.contiguous()
        B = B if B.stride(-1) == 1 else B.contiguous()
        C = C if C.stride(-1) == 1 else C.contiguous()
    lib = _build.load()
    y = torch.empty(b, s, h, p, dtype=x.dtype, device=x.device)
    final = torch.empty(b, h, n, p, dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), final.data_ptr())
    with torch.cuda.device(x.device):        # the launch's current device
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            err = lib.smlt_ssd_scan_wgmma(*ptrs, b, s, h, p, n, chunk, st,
                                          stream)
        else:
            err = lib.smlt_ssd_scan(*ptrs, b, s, h, p, n, chunk, B.stride(0),
                                    B.stride(1), C.stride(0), C.stride(1),
                                    _DTYPES[x.dtype], stream)
    _build.check(err, f"ssd_scan ({route})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return y, final


_ssd_op = torch.library.custom_op("smlt::ssd_scan", _ssd_impl,
                                  mutates_args=())


@_ssd_op.register_fake
def _(x, dt, A, B, C, D, chunk, route):
    b, s, h, p = x.shape
    n = B.shape[-1]
    _check_kernel_inputs(x, B, C, p, n)
    return (x.new_empty(b, s, h, p),
            x.new_empty(b, h, n, p, dtype=torch.float32))


@register_flop_formula(torch.ops.smlt.ssd_scan)
def ssd_flops(x_shape, dt_shape, A_shape, B_shape, C_shape, D_shape,
              chunk, *args, **kwargs) -> int:
    """FLOPs of the chunk GEMMs, per (batch, head, chunk of Q): C B^T
    (2 Q^2 n), the masked scores times x (2 Q^2 p), C times the carried
    state (2 Q n p) and the state update B^T x (2 Q n p)."""
    b, s, h, p = x_shape
    n, q = B_shape[-1], chunk
    return 2 * b * h * (s // q) * (q * q * (n + p) + 2 * q * n * p)


_TILE_PRODUCTS = ("cb", "px", "cs", "bx")


def wgmma_tile(which: str, *, c=None, bm=None, x=None, f=None):
    """One tile of one of the tensor-core kernel's products, run by the
    kernel's own device code on TMA-loaded tiles, for the card tests
    (counts no launch). c, bm: (64, WGMMA_NPAD) bf16; x: (64, 64) bf16;
    f32 out:
      "cb": c @ bm^T (64, 64), both K-major;
      "px": f @ x (64, 64), f (64, 64) f32 split into bf16 hi + lo;
      "cs": c @ f (64, 64), f (WGMMA_NPAD, 64) f32 split, MN-major;
      "bx": (bm * f[:, None])^T @ x (WGMMA_NPAD, 64), f (64,) f32, the
            decayed B^T read transposed from the B tile and split.
    Operands a product does not use may be omitted."""
    if which not in _TILE_PRODUCTS:
        raise ValueError(f"which {which!r} not in {_TILE_PRODUCTS}")
    dev = next(t.device for t in (c, bm, x, f) if t is not None)
    shapes = {"c": (64, WGMMA_NPAD), "bm": (64, WGMMA_NPAD), "x": (64, 64)}
    ops = {}
    for name, t in (("c", c), ("bm", bm), ("x", x)):
        if t is None:
            t = torch.zeros(shapes[name], dtype=torch.bfloat16, device=dev)
        if tuple(t.shape) != shapes[name] or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} wants {shapes[name]} bf16, got "
                             f"{tuple(t.shape)} {t.dtype}")
        ops[name] = t.contiguous()
    f_shape = {"cb": (1,), "px": (64, 64), "cs": (WGMMA_NPAD, 64),
               "bx": (64,)}[which]
    f = torch.zeros(f_shape, device=dev) if f is None else f
    if tuple(f.shape) != f_shape:
        raise ValueError(f"f wants {f_shape}, got {tuple(f.shape)}")
    f = f.float().contiguous()
    out = torch.empty(WGMMA_NPAD if which == "bx" else 64, 64,
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().smlt_ssd_wgmma_tile(
            _TILE_PRODUCTS.index(which), ops["c"].data_ptr(),
            ops["bm"].data_ptr(), ops["x"].data_ptr(), f.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"smlt_ssd_wgmma_tile ({which})")
    return out
