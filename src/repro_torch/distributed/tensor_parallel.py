"""Tensor parallelism over the ``model`` mesh axis: the collectives a
Megatron-style split of the layers needs, as autograd functions over the
model group.

The reference has no such file: GSPMD derives the collectives from the
sharding specs. The port places them by hand where GSPMD places them.
Activations between the layers are whole on every rank of the model group
(replicated); a layer that holds its weights' model parts
(``distributed/sharding.py``'s specs) works on its part and hands back a
whole result:

  copy_to_model      identity forward, all-reduce backward: a whole
                     activation entering a split computation (each rank's
                     gradient of it is a partial sum);
  reduce_from_model  all-reduce forward, identity backward: the partial
                     results of a split computation summed into a whole
                     one, which every rank then uses alike;
  gather_from_model  all-gather along a dim forward, this rank's slice of
                     the gradient backward;
  sum_over_model     all-reduce forward and backward: a sum that each rank
                     goes on to use for its own part only (the gated norm's
                     sum of squares over a split width).

The steps (``launch/steps.py``) run the model inside ``model_parallel``;
outside it, or with a model group of one rank, every function here is the
identity and issues nothing, so the program is the one without tensor
parallelism, launch for launch. The collectives go through
``core/hier_sync.py``, so the dry run's recorder counts them.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.core.hier_sync import all_gather, all_reduce

_GROUP = None      # (group, size, rank) inside model_parallel, size > 1


@contextlib.contextmanager
def model_parallel(group):
    """Run the block with ``group`` (a process group, or None) as the model
    group; a group of one rank is no tensor parallelism."""
    global _GROUP
    prev = _GROUP
    n = 1 if group is None else dist.get_world_size(group)
    _GROUP = (group, n, dist.get_rank(group)) if n > 1 else None
    try:
        yield
    finally:
        _GROUP = prev


def size() -> int:
    """Ranks in the model group (1 outside ``model_parallel``)."""
    return 1 if _GROUP is None else _GROUP[1]


def rank() -> int:
    """This rank's place in the model group."""
    return 0 if _GROUP is None else _GROUP[2]


def bounds(n: int, i: int = None):
    """The part [lo, hi) of ``n`` items (heads, experts, rows) that model
    rank ``i`` (default this rank) takes: contiguous, and equal where the
    model size divides ``n``."""
    m, i = size(), rank() if i is None else i
    return i * n // m, (i + 1) * n // m


def gather_dim(x, dim: int, group, n: int):
    """Every rank's ``x`` concatenated along ``dim`` (a new tensor)."""
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] * n,) + moved.shape[1:],
                      dtype=x.dtype, device=x.device)
    return all_gather(out, moved, group).movedim(0, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, i):
        ctx.dim, ctx.k, ctx.i = dim, x.shape[dim], i
        return gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.i * ctx.k, ctx.k), None, None, None, None


def copy_to_model(x):
    return x if _GROUP is None else _Copy.apply(x, _GROUP[0])


def reduce_from_model(x):
    return x if _GROUP is None else _Reduce.apply(x, _GROUP[0])


def sum_over_model(x):
    return copy_to_model(reduce_from_model(x))


def gather_from_model(x, dim: int):
    if _GROUP is None:
        return x
    group, n, i = _GROUP
    return _Gather.apply(x, dim % x.ndim, group, n, i)


def max_over_model(x):
    """The elementwise max over the model group, outside autograd (a
    softmax's shift)."""
    x = x.detach()
    if _GROUP is None:
        return x
    return all_reduce(x.clone(), _GROUP[0], op=dist.ReduceOp.MAX)


def used_part(w, dim: int, full: int, lo: int, hi: int):
    """Entries [lo, hi) along ``dim`` of a leaf whose whole width is
    ``full``, from what this rank holds of it: its model part where that
    is exactly those entries; else the whole leaf (gathered over the model
    group where it is held split), through ``copy_to_model``, since this
    rank's use of it is then a part of the model group's."""
    k = w.shape[dim]
    if k != full and lo == rank() * k and hi - lo == k:
        return w
    if k != full:
        w = gather_from_model(w, dim)
    return copy_to_model(w).narrow(dim, lo, hi - lo)
