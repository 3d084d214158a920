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

Sequence parallelism (``cfg.seq_shard``, the reference's
``seq_constraint``: Megatron's sequence parallelism) is a mode of
``model_parallel``: between the layers each rank then holds its slice of
the sequence (dim 1) of the stream, and the layers' entry and exit take
their sequence-parallel form:

  enter       copy_to_model, or the all-gather of the sequence slices
              forward and the reduce-scatter of the gradient backward;
  leave       reduce_from_model, or the reduce-scatter of the partial
              results along the sequence forward and the all-gather of
              the gradient backward;
  seq_slice   this rank's slice of a whole activation (the embedding's
              output), its gradient all-gathered backward;
  seq_gather  the whole sequence from the slices, for a computation every
              rank runs alike (the unembedding of a whole vocabulary, the
              encoder's output), this rank's slice of the gradient
              backward.

  seq_leaf    a whole (replicated) leaf read where each rank does only
              its part of the work (a norm's scale on the slice, the SSM
              layers' B / C weights read by this rank's heads alone): its
              gradient is summed over the group backward.

Norms and residual adds run on the slice, so every site that reads a
whole leaf there passes it through ``seq_leaf``, and each rank's copy
takes the whole gradient. Without the mode the last three are the
identity and the first two the plain pair.

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

from repro_torch.core.hier_sync import all_gather, all_reduce, reduce_scatter

# (group, size, rank, sequence parallel) inside model_parallel, size > 1
_GROUP = None
SEQ_DIM = 1        # the sequence dim of the stream (b, s, d)


@contextlib.contextmanager
def model_parallel(group, seq: bool = False):
    """Run the block with ``group`` (a process group, or None) as the model
    group, with sequence parallelism when ``seq``; a group of one rank is
    no tensor parallelism."""
    global _GROUP
    prev = _GROUP
    n = 1 if group is None else dist.get_world_size(group)
    _GROUP = (group, n, dist.get_rank(group), seq) if n > 1 else None
    try:
        yield
    finally:
        _GROUP = prev


@contextlib.contextmanager
def whole_sequence():
    """Within the block the stream is whole on every rank (a layer that
    gathered it and runs the plain pair inside: the MoE FFN)."""
    global _GROUP
    prev = _GROUP
    if prev is not None:
        _GROUP = prev[:3] + (False,)
    try:
        yield
    finally:
        _GROUP = prev


def seq_parallel() -> bool:
    """Whether the stream is split along the sequence over the group."""
    return _GROUP is not None and _GROUP[3]


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


def scatter_dim(x, dim: int, group, n: int):
    """This rank's part along ``dim`` of the sum over the ranks of ``x``
    (a new tensor)."""
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n,) + moved.shape[1:],
                      dtype=x.dtype, device=x.device)
    return reduce_scatter(out, moved, group).movedim(0, dim)


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


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, i):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        k = x.shape[dim] // n
        return x.narrow(dim, i * k, k)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.group, ctx.n), None, None, None, \
            None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return scatter_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.group, ctx.n), None, None, None


def copy_to_model(x):
    return x if _GROUP is None else _Copy.apply(x, _GROUP[0])


def reduce_from_model(x):
    return x if _GROUP is None else _Reduce.apply(x, _GROUP[0])


def sum_over_model(x):
    return copy_to_model(reduce_from_model(x))


def gather_from_model(x, dim: int):
    if _GROUP is None:
        return x
    group, n, i, _ = _GROUP
    return _Gather.apply(x, dim % x.ndim, group, n, i)


def enter(x):
    """The stream entering a split computation (each rank's gradient of
    what it returns is a partial sum)."""
    if not seq_parallel():
        return copy_to_model(x)
    return _Enter.apply(x, SEQ_DIM, _GROUP[0], _GROUP[1])


def leave(x):
    """A split computation's partial results summed back into the
    stream."""
    if not seq_parallel():
        return reduce_from_model(x)
    return _Leave.apply(x, SEQ_DIM, _GROUP[0], _GROUP[1])


def seq_slice(x):
    """A whole activation -> the stream: this rank's slice of the
    sequence under sequence parallelism, else ``x``."""
    if not seq_parallel():
        return x
    group, n, i, _ = _GROUP
    if x.shape[SEQ_DIM] % n:
        raise ValueError(f"a sequence of {x.shape[SEQ_DIM]} on a model "
                         f"axis of {n} under seq_shard")
    return _Slice.apply(x, SEQ_DIM, group, n, i)


def seq_gather(x):
    """The stream -> the whole activation, for a computation that every
    rank runs alike."""
    return gather_from_model(x, SEQ_DIM) if seq_parallel() else x


def seq_leaf(w):
    """A whole leaf read on this rank's part of sequence-parallel work:
    identity forward, its gradient summed over the model group backward
    (``copy_to_model``); ``w`` itself without the mode."""
    return copy_to_model(w) if seq_parallel() else w


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
    rank's use of it is then a part of the model group's; not narrowed
    where that is all of it (a narrow's backward writes its gradient into
    a zero leaf)."""
    k = w.shape[dim]
    if k != full and lo == rank() * k and hi - lo == k:
        return w
    if k != full:
        w = gather_from_model(w, dim)
    w = copy_to_model(w)
    return w if hi - lo == full else w.narrow(dim, lo, hi - lo)
