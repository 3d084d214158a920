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
raises. Under a dispatch mode or on a fake tensor (``traced``: the dry
run, ``FlopCounterMode``) the forward goes through the custom op
``smlt::flash_attention_fwd``, whose fake version gives the kernel's
output layout with no launch and whose formula, ``flash_flops``, counts
the products of the tiles the route's kernel runs, on every device.
``FlashAttention`` is the differentiable form: the kernel forward, which
also writes each query's logsumexp when a gradient is wanted, and the
backward kernels of ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``,
routed by dtype as the forward: dK / dV over key tiles, then dQ over query
tiles, no atomics, so its bits repeat), in place of the reference's vjp of
the blockwise attention (``ops.py:48-79``). Traced, the backward is the
custom op ``smlt::flash_attention_bwd`` (FLOPs: ``flash_bwd_flops``).

The logsumexp ``lse`` is one convention on both routes and in the plain
version: f32 (b, h, sq), the natural log of the sum over a query's keys of
exp(d^-0.5 q.k), masked scores -1e30 as in the forward; the backward
recomputes P = exp(d^-0.5 q.k - lse). The tensor-core kernels work in base
2 and convert on the way in and out.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches of flash_attention (plain calls not counted)
ROUTE_LAUNCHES = {"wgmma": 0, "cuda_cores": 0}  # the same launches by route
BWD_LAUNCHES = 0  # launches of flash_attention_bwd (its three kernels: one)
BWD_ROUTE_LAUNCHES = {"wgmma": 0, "cuda_cores": 0}

HEAD_DIMS = (32, 64, 112, 128)
WGMMA_BK = 128  # keys per tile of the tensor-core kernel (BK in its source)
# (queries, keys) per tile of each route's kernel (BQ, BK in its source)
ROUTE_TILES = {"wgmma": (128, WGMMA_BK), "cuda_cores": (64, 64)}
# (queries, keys) per tile of each route's two backward kernels: dK / dV
# (four products a tile pair) and dQ (three)
BWD_TILES = {"wgmma": ((64, 128), (128, 64)),
             "cuda_cores": ((64, 64), (64, 64))}
# the backward's per-query scratch rows are padded to this many queries
# (ROW_PAD in csrc/flash_attention_bwd.cu)
BWD_ROW_PAD = 128
NEG_INF = -1e30


def _masked_scores(qb, kf, start: int, causal: bool, window: int):
    """f32 scores of the scaled queries ``qb`` (b, h, n, d), the first at
    position ``start``, against every key of ``kf``; -1e30 where masked."""
    sk = kf.shape[2]
    kpos = torch.arange(sk, device=qb.device)
    qpos = start + torch.arange(qb.shape[2], device=qb.device)
    s = qb @ kf.transpose(-1, -2)
    mask = torch.ones(qb.shape[2], sk, dtype=torch.bool, device=qb.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    return torch.where(mask, s, NEG_INF)


def plain_flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """The same function in plain PyTorch, 256 queries at a time:
    f32 scores of q * d^-0.5 against k, -1e30 where masked, then
    (exp(s - max) @ v) / max(sum exp(s - max), 1e-30). (b, h, s, d)."""
    d = q.shape[3]
    kf = k.float()
    vf = v.float()
    outs = []
    for start in range(0, q.shape[2], 256):
        qb = q[:, :, start:start + 256].float() * d ** -0.5
        s = _masked_scores(qb, kf, start, causal, window)
        p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        outs.append((p @ vf) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30))
    return torch.cat(outs, dim=2).to(q.dtype)


def plain_flash_lse(q, k, *, causal: bool = True, window: int = 0):
    """The forward's logsumexp in plain PyTorch: f32 (b, h, sq), the natural
    log of sum over keys of exp(s) for plain_flash_attention's masked,
    scaled scores s."""
    d = q.shape[3]
    kf = k.float()
    return torch.cat([torch.logsumexp(_masked_scores(
        q[:, :, start:start + 256].float() * d ** -0.5, kf, start, causal,
        window), dim=-1) for start in range(0, q.shape[2], 256)], dim=2)


def plain_flash_attention_bwd(q, k, v, out, lse, g, *, causal: bool = True,
                              window: int = 0):
    """The backward in plain f32 PyTorch, 256 queries at a time: with
    P = exp(s - lse) for the masked, scaled scores s, D = rowsum(g o out),
    dS = P o (g v^T - D): dq = d^-0.5 dS k, dk = d^-0.5 dS^T q, dv = P^T g.
    Returns (dq, dk, dv) in the inputs' dtypes, (b, h, s, d)."""
    d = q.shape[3]
    scale = d ** -0.5
    kf = k.float()
    vf = v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    big_d = (g.float() * out.float()).sum(-1)
    dqs = []
    for start in range(0, q.shape[2], 256):
        blk = slice(start, start + 256)
        qb = q[:, :, blk].float() * scale
        gb = g[:, :, blk].float()
        p = torch.exp(_masked_scores(qb, kf, start, causal, window)
                      - lse[:, :, blk, None])
        dv += p.transpose(-1, -2) @ gb
        ds = p * (gb @ vf.transpose(-1, -2) - big_d[:, :, blk, None])
        dqs.append((ds @ kf) * scale)
        dk += ds.transpose(-1, -2) @ qb
    return (torch.cat(dqs, dim=2).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: (b, h, sq, d); k, v: (b, h, sk, d) -> (b, h, sq, d), a view of
    (b, sq, h, d) memory, and with ``return_lse`` also the f32 (b, h, sq)
    logsumexp the backward reads. Forward only. A launch on a CUDA tensor
    (and on a meta tensor, which the CPU tests stand in for one), the plain
    version on a CPU tensor; when ``traced``, through the custom op
    ``smlt::flash_attention_fwd`` (``smlt::flash_attention_fwd_lse``),
    whose fake version gives a fake tensor the kernel's outputs with no
    launch."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (b, h, s, d) with equal "
                         "b, h, d and k.shape == v.shape")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if return_lse:
        if traced(q):
            return torch.ops.smlt.flash_attention_fwd_lse(q, k, v, causal,
                                                          window)
        return _flash_lse_impl(q, k, v, causal, window)
    if traced(q):
        return torch.ops.smlt.flash_attention_fwd(q, k, v, causal, window)
    return _flash_impl(q, k, v, causal, window)


def traced(x) -> bool:
    """Whether a call on ``x`` must go through its custom op: under a
    dispatch mode (``FlopCounterMode``, ``FakeTensorMode``) or on a tensor
    subclass (a fake tensor). A plain tensor with no mode calls the
    implementation directly, which saves the dispatcher's tens of
    microseconds a call (the kernel at olmo-1b's shape runs 0.09 ms)."""
    return (type(x) is not torch.Tensor
            or _get_current_dispatch_mode() is not None)


def _bshd_view(q):
    b, h, sq, d = q.shape
    return q.new_empty(b, sq, h, d).transpose(1, 2)


def _lse_like(q):
    b, h, sq, _ = q.shape
    return q.new_empty(b, h, sq, dtype=torch.float32)


def _flash_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int) -> torch.Tensor:
    """The op on real tensors: the plain version on the CPU, a launch on
    any other device."""
    return _flash_run(q, k, v, causal, window, None)


def _flash_lse_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The op with the logsumexp, on real tensors."""
    lse = _lse_like(q)
    return _flash_run(q, k, v, causal, window, lse), lse


def _flash_run(q, k, v, causal: bool, window: int, lse):
    """The output; and into ``lse``, unless None, the logsumexp."""
    if q.device.type == "cpu":
        if lse is not None:
            lse.copy_(plain_flash_lse(q, k, causal=causal, window=window))
        return _bshd_view(q).copy_(plain_flash_attention(
            q, k, v, causal=causal, window=window))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    route = flash_route(q.dtype, d)
    strides = [s for x in (q, k, v) for s in kernel_strides(x, route)]
    global LAUNCHES
    lib = _build.load()
    out = _bshd_view(q)
    strides += kernel_strides(out, "cuda_cores")
    st = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):        # the launch's current device
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        args = (b, h, sq, sk, d, int(causal), int(window), d ** -0.5, st,
                stream)
        if lse is None:
            fn = (lib.smlt_flash_attention_fwd_wgmma if route == "wgmma"
                  else lib.smlt_flash_attention_fwd)
            err = fn(*ptrs, *args)
        else:
            fn = (lib.smlt_flash_attention_fwd_wgmma_lse if route == "wgmma"
                  else lib.smlt_flash_attention_fwd_lse)
            err = fn(*ptrs, lse.data_ptr(), *args)
    _build.check(err, f"flash_attention ({route})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return out


_flash_fwd = torch.library.custom_op("smlt::flash_attention_fwd",
                                     _flash_impl, mutates_args=())
_flash_fwd_lse = torch.library.custom_op("smlt::flash_attention_fwd_lse",
                                         _flash_lse_impl, mutates_args=())


@_flash_fwd.register_fake
def _(q, k, v, causal, window):
    flash_route(q.dtype, q.shape[3])       # what the card's kernels take
    return _bshd_view(q)


@_flash_fwd_lse.register_fake
def _(q, k, v, causal, window):
    flash_route(q.dtype, q.shape[3])
    return _bshd_view(q), _lse_like(q)


def flash_tiles_run(sq: int, sk: int, bq: int, bk: int, causal: bool,
                    window: int) -> int:
    """The (query tile, key tile) pairs a kernel with bq x bk tiles runs:
    the reference's skip rule, a key tile wholly above the diagonal or
    wholly outside the window is not run."""
    n_k = -(-sk // bk)
    total = 0
    for q0 in range(0, sq, bq):
        hi = min(n_k, (q0 + bq - 1) // bk + 1) if causal else n_k
        lo = max(0, -(-(q0 - window + 2 - bk) // bk)) if window else 0
        total += max(hi - lo, 0)
    return total


@register_flop_formula([torch.ops.smlt.flash_attention_fwd,
                       torch.ops.smlt.flash_attention_fwd_lse], get_raw=True)
def flash_flops(q, k, v, causal, window, *args, **kwargs) -> int:
    """FLOPs of the kernel the route of q's dtype runs: Q K^T and P V,
    2 * bq * bk * d each, over the tiles it runs (``flash_tiles_run``)."""
    b, h, sq, d = q.shape
    bq, bk = ROUTE_TILES[flash_route(q.dtype, d)]
    return 4 * b * h * bq * bk * d * flash_tiles_run(sq, k.shape[2], bq, bk,
                                                     causal, window)


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


def flash_attention_bwd(q, k, v, out, lse, g, *, causal: bool = True,
                        window: int = 0):
    """The gradients (dq, dk, dv) of flash_attention's output ``out``
    against ``g`` (dO), from q, k, v, ``out`` and the forward's ``lse``;
    each a (b, h, s, d) view of (b, s, h, d) memory in the inputs' dtype.
    A launch on a CUDA (or meta) tensor, the plain version on a CPU tensor;
    traced, the custom op ``smlt::flash_attention_bwd``. The kernels read
    q, k, v, ``out`` and ``g`` through their strides (d contiguous; on the
    tensor-core route q, k, v and ``g`` through TMA) and ``lse`` contiguous:
    a layout they cannot read raises, nothing is copied."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (k.shape != (b, h, sk, d) or v.shape != k.shape
            or out.shape != q.shape or g.shape != q.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, out {tuple(out.shape)}, g "
                         f"{tuple(g.shape)}: want q, out, g (b, h, sq, d) "
                         "and k, v (b, h, sk, d)")
    if any(x.dtype != q.dtype for x in (k, v, out, g)):
        raise TypeError("flash_attention_bwd takes q, k, v, out, g of one "
                        "dtype")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want "
                         f"({b}, {h}, {sq}) float32")
    if traced(q):
        return torch.ops.smlt.flash_attention_bwd(q, k, v, out, lse, g,
                                                  causal, window)
    return _flash_bwd_impl(q, k, v, out, lse, g, causal, window)


def _bwd_scratch(q):
    """The backward kernels' per-query rows of lse and D, padded to
    BWD_ROW_PAD queries: (2, b * h * padded) f32."""
    b, h, sq, _ = q.shape
    pad = -(-sq // BWD_ROW_PAD) * BWD_ROW_PAD
    return q.new_empty(2, b * h * pad, dtype=torch.float32)


def _flash_bwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                    causal: bool, window: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on real tensors: the plain version on the CPU, the
    route's kernels on any other device."""
    if q.device.type == "cpu":
        grads = plain_flash_attention_bwd(q, k, v, out, lse, g,
                                          causal=causal, window=window)
        return tuple(_bshd_view(x).copy_(dx) for x, dx in zip((q, k, v),
                                                               grads))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    route = flash_route(q.dtype, d)
    if not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous, got strides "
                         f"{lse.stride()}")
    strides = [s for x in (q, k, v) for s in kernel_strides(x, route)]
    strides += kernel_strides(out, "cuda_cores")
    strides += kernel_strides(g, route)
    global BWD_LAUNCHES
    lib = _build.load()
    grads = (_bshd_view(q), _bshd_view(k), _bshd_view(v))
    strides += [s for x in grads for s in kernel_strides(x, "cuda_cores")]
    rows = _bwd_scratch(q)
    st = (ctypes.c_longlong * 24)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = (lib.smlt_flash_attention_bwd_wgmma if route == "wgmma"
              else lib.smlt_flash_attention_bwd)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 g.data_ptr(), lse.data_ptr(),
                 *(x.data_ptr() for x in grads), rows[0].data_ptr(),
                 rows[1].data_ptr(), b, h, sq, sk, d, int(causal),
                 int(window), d ** -0.5, st, stream)
    _build.check(err, f"flash_attention_bwd ({route})")
    BWD_LAUNCHES += 1
    BWD_ROUTE_LAUNCHES[route] += 1
    return grads


_flash_bwd = torch.library.custom_op("smlt::flash_attention_bwd",
                                     _flash_bwd_impl, mutates_args=())


@_flash_bwd.register_fake
def _(q, k, v, out, lse, g, causal, window):
    flash_route(q.dtype, q.shape[3])
    _bwd_scratch(q)                        # what the wrapper allocates too
    return _bshd_view(q), _bshd_view(k), _bshd_view(v)


@register_flop_formula(torch.ops.smlt.flash_attention_bwd, get_raw=True)
def flash_bwd_flops(q, k, v, out, lse, g, causal, window, *args,
                    **kwargs) -> int:
    """FLOPs of the backward kernels the route of q's dtype runs, over the
    tiles each runs (``flash_tiles_run`` with ``BWD_TILES``): dK / dV's
    S, dP, dV and dK and dQ's S, dP and dQ, 2 * bq * bk * d each."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    (bq1, bk1), (bq2, bk2) = BWD_TILES[flash_route(q.dtype, d)]
    return 2 * b * h * d * (
        4 * bq1 * bk1 * flash_tiles_run(sq, sk, bq1, bk1, causal, window)
        + 3 * bq2 * bk2 * flash_tiles_run(sq, sk, bq2, bk2, causal, window))


class FlashAttention(torch.autograd.Function):
    """Kernel forward, kernel backward. The forward writes the logsumexp
    only when an input wants a gradient; the backward reads it with q, k,
    v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.causal, ctx.window = causal, window
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention(q, k, v, causal=causal, window=window)
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None
