"""AdamW's update and the global-norm clip's sum of squares, one leaf a
launch.

``adamw_update`` runs ``csrc/adamw.cu::smlt_adamw_update``: one pass
that reads the parameter, its gradient and both moments, writes the moments
in place and returns the new parameter as a new tensor, each bit-equal to
what ``plain_adamw_update`` computes on the same CUDA tensors.
``sum_squares`` runs ``smlt_sum_squares``: one read of the gradient, block
partials in double, then one finishing block, in a fixed order (two calls
are bit-equal). They replace no TPU kernel: the reference's ``optim/adamw.py``
is plain ``jnp`` that XLA fuses; eager PyTorch runs the plain versions
below as about twenty elementwise kernels a leaf. On an H100 both are bound
by bytes: 2 * |p| + |g| + 16 bytes a parameter for the update (22 with bf16
p and g) and |g| for the sum of squares.

p and g are each f32 or bf16; m and v are f32 and contiguous (they are
updated in place). A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Under a dispatch mode or on a fake tensor
off the CPU the call goes through the custom ops ``smlt::adamw_update``
and ``smlt::sum_squares``, whose fake versions give the outputs' shapes
with no launch. Neither has a FLOP formula: ``FlopCounterMode`` counts no
elementwise work.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import traced

# calls on the card that launched: LAUNCHES one kernel each (an empty leaf
# launches none and is not counted), SUMSQ_LAUNCHES two (the block partials,
# then the finishing block); plain calls are not counted
LAUNCHES = 0        # adamw_update
SUMSQ_LAUNCHES = 0  # sum_squares

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SUMSQ_BLOCKS = 1024  # the partials' length, and the sum's most blocks


def plain_adamw_update(p, g, m, v, scale, lr: float, b1: float, b2: float,
                       bc1: float, bc2: float, eps: float,
                       weight_decay: float):
    """The update in f32, m and v in place; returns the new parameter in
    p's dtype. ``scale`` is the clip's factor (a one-element f32 tensor) or
    None."""
    g = g.float() if scale is None else g.float() * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    pf = p.float()
    delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
    return (pf - lr * delta).to(p.dtype)


def plain_sum_squares(g):
    return torch.sum(torch.square(g.float()))


def f32_reciprocal(x: float) -> float:
    """The factor by which PyTorch multiplies a CUDA tensor to divide it by
    the Python scalar x: 1 / x in double, rounded to f32."""
    return float(np.float32(1 / x))


def _check_update(p, g, m, v, scale):
    if p.dtype not in _DTYPES or g.dtype not in _DTYPES:
        raise TypeError(f"adamw_update takes f32 or bf16 p and g, got "
                        f"{p.dtype}, {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"adamw_update takes f32 moments, got {m.dtype}, "
                        f"{v.dtype}")
    if not p.shape == g.shape == m.shape == v.shape:
        raise ValueError(f"p {tuple(p.shape)}, g {tuple(g.shape)}, m "
                         f"{tuple(m.shape)}, v {tuple(v.shape)}: want one "
                         "shape")
    if not (m.is_contiguous() and v.is_contiguous()):
        raise ValueError("adamw_update updates m and v in place: they must "
                         "be contiguous")
    if scale is not None and (scale.numel() != 1
                              or scale.dtype != torch.float32):
        raise ValueError(f"scale must be one f32 value, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if any(t.device != p.device for t in (g, m, v, scale) if t is not None):
        raise ValueError("adamw_update's tensors must share p's device")


def _launch_update(p, g, m, v, scale, lr, b1, b2, bc1, bc2, eps,
                   weight_decay):
    _check_update(p, g, m, v, scale)
    global LAUNCHES
    p, g = p.contiguous(), g.contiguous()
    out = torch.empty_like(p)
    if not p.numel():
        return out
    lib = _build.load()
    with torch.cuda.device(p.device):        # the launch's current device
        err = lib.smlt_adamw_update(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if scale is None else scale.data_ptr(),
            p.numel(), lr, b1, 1 - b1, b2, 1 - b2, f32_reciprocal(bc1),
            f32_reciprocal(bc2), eps, weight_decay, _DTYPES[p.dtype],
            _DTYPES[g.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "smlt_adamw_update")
    LAUNCHES += 1
    return out


def _update_impl(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, scale: Optional[torch.Tensor], lr: float,
                 b1: float, b2: float, bc1: float, bc2: float, eps: float,
                 weight_decay: float) -> torch.Tensor:
    """The op on real tensors: the plain version on the CPU, a launch on
    any other device."""
    run = plain_adamw_update if p.device.type == "cpu" else _launch_update
    return run(p, g, m, v, scale, lr, b1, b2, bc1, bc2, eps, weight_decay)


_update_op = torch.library.custom_op("smlt::adamw_update", _update_impl,
                                     mutates_args=("m", "v"))


@_update_op.register_fake
def _(p, g, m, v, scale, lr, b1, b2, bc1, bc2, eps, weight_decay):
    _check_update(p, g, m, v, scale)
    return p.new_empty(p.shape)


def adamw_update(p, g, m, v, scale=None, *, lr: float, b1: float, b2: float,
                 bc1: float, bc2: float, eps: float, weight_decay: float):
    """One leaf's AdamW step: m and v (f32) updated in place, the new
    parameter returned in p's dtype. ``scale`` is the clip's factor on the
    device (one f32 value) or None; bc1 and bc2 are the bias corrections
    1 - b1^t and 1 - b2^t."""
    args = (p, g, m, v, scale, lr, b1, b2, bc1, bc2, eps, weight_decay)
    if p.device.type != "cpu" and traced(p):
        return torch.ops.smlt.adamw_update(*args)
    return _update_impl(*args)


def _check_sum_squares(g):
    if g.dtype not in _DTYPES:
        raise TypeError(f"sum_squares takes f32 or bf16, got {g.dtype}")


def _launch_sum_squares(g):
    _check_sum_squares(g)
    global SUMSQ_LAUNCHES
    lib = _build.load()
    g = g.contiguous()
    partials = torch.empty(SUMSQ_BLOCKS, dtype=torch.float64,
                           device=g.device)
    out = torch.empty((), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):        # the launch's current device
        err = lib.smlt_sum_squares(
            g.data_ptr(), partials.data_ptr(), partials.numel(),
            out.data_ptr(), g.numel(), _DTYPES[g.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "smlt_sum_squares")
    SUMSQ_LAUNCHES += 1
    return out


def _sum_squares_impl(g: torch.Tensor) -> torch.Tensor:
    if g.device.type == "cpu":
        return plain_sum_squares(g)
    return _launch_sum_squares(g)


_sum_squares_op = torch.library.custom_op("smlt::sum_squares",
                                          _sum_squares_impl, mutates_args=())


@_sum_squares_op.register_fake
def _(g):
    _check_sum_squares(g)
    return g.new_empty((), dtype=torch.float32)


def sum_squares(g):
    """The f32 sum of g * g over every element (a 0-dim tensor)."""
    if g.device.type != "cpu" and traced(g):
        return torch.ops.smlt.sum_squares(g)
    return _sum_squares_impl(g)
