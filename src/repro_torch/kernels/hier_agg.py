"""Shard aggregation (Fig. 5, step 3): the mean of an (n_workers, L) stack
of gradient shards over the workers.

``aggregate_shards`` replaces the Pallas kernel
``src/repro/kernels/hier_agg.py::_agg_kernel`` with the CUDA kernel in
``csrc/hier_agg.cu``. On an H100 it is bound by bytes: (n + 1) * L
elements cross device memory, so the least time is (n + 1) * L * itemsize
/ 3.35 TB/s. The kernel streams each worker row once with 16-byte loads and
sums in worker order in f32, then divides by n: the plain version's
arithmetic, so f32 results are bit-equal to it.

``aggregate_and_apply`` replaces ``_agg_apply_kernel`` with a second entry
of the same CUDA file: the same mean, then ``param - lr * mean`` in f32,
rounded once to the parameter's dtype; bound by (n + 2) * L elements of
bytes. Its f32 results are bit-equal to its plain version too.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches of aggregate_shards (plain calls not counted)
APPLY_LAUNCHES = 0  # kernel launches of aggregate_and_apply

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _mean_f32(shards: torch.Tensor) -> torch.Tensor:
    """Sum in worker order 0..n-1 in f32, then a true division by n (a
    tensor divisor: a CUDA tensor divided by a Python scalar is computed
    as a multiplication by its reciprocal)."""
    acc = shards[0].float()
    for w in range(1, shards.shape[0]):
        acc = acc + shards[w].float()
    return acc / torch.tensor(float(shards.shape[0]), device=acc.device)


def plain_aggregate_shards(shards: torch.Tensor) -> torch.Tensor:
    return _mean_f32(shards).to(shards.dtype)


def plain_aggregate_and_apply(shards: torch.Tensor, param: torch.Tensor,
                              lr: float) -> torch.Tensor:
    return (param.float() - lr * _mean_f32(shards)).to(param.dtype)


def aggregate_shards(shards: torch.Tensor) -> torch.Tensor:
    """(n_workers, L) -> (L,) mean over workers, in the input dtype."""
    if shards.dim() != 2:
        raise ValueError(f"shards must be (n, L), got {tuple(shards.shape)}")
    if shards.device.type == "cpu":
        return plain_aggregate_shards(shards)
    if shards.dtype not in _DTYPES:
        raise TypeError(f"aggregate_shards takes f32 or bf16, got {shards.dtype}")
    global LAUNCHES
    lib = _build.load()
    shards = shards.contiguous()
    n, length = shards.shape
    out = torch.empty(length, dtype=shards.dtype, device=shards.device)
    with torch.cuda.device(shards.device):   # the launch's current device
        err = lib.smlt_aggregate_shards(
            shards.data_ptr(), out.data_ptr(), n, length,
            _DTYPES[shards.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "smlt_aggregate_shards")
    LAUNCHES += 1
    return out


def aggregate_and_apply(shards: torch.Tensor, param: torch.Tensor,
                        lr: float) -> torch.Tensor:
    """Fused mean + SGD apply on the owned shard: (n, L) shards and an (L,)
    param of the same dtype -> (L,) ``param - lr * mean``."""
    if shards.dim() != 2 or param.shape != shards.shape[1:]:
        raise ValueError(f"shards (n, L) and param (L,) wanted, got "
                         f"{tuple(shards.shape)} and {tuple(param.shape)}")
    if shards.device.type == "cpu":
        return plain_aggregate_and_apply(shards, param, lr)
    if shards.dtype not in _DTYPES or param.dtype != shards.dtype:
        raise TypeError(f"aggregate_and_apply takes f32 or bf16 shards and "
                        f"param of one dtype, got {shards.dtype}, "
                        f"{param.dtype}")
    global APPLY_LAUNCHES
    lib = _build.load()
    shards, param = shards.contiguous(), param.contiguous()
    n, length = shards.shape
    out = torch.empty_like(param)
    with torch.cuda.device(shards.device):   # the launch's current device
        err = lib.smlt_aggregate_and_apply(
            shards.data_ptr(), param.data_ptr(), out.data_ptr(), n, length,
            float(lr), _DTYPES[shards.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "smlt_aggregate_and_apply")
    APPLY_LAUNCHES += 1
    return out
