"""Hierarchical model synchronization on ``torch.distributed`` collectives
(paper Section 3.3); port of the JAX package's ``core/hier_sync.py``.

The paper's ScatterReduce dataflow (Fig. 5) maps 1:1 onto collectives:

  shard generator  + upload     ->  reduce-scatter  (reduce_scatter_tensor)
  shard aggregator (mean)       ->  (the sum inside the reduce-scatter) / n
  re-upload + global aggregator ->  all-gather      (all_gather_into_tensor)

The centralized-PS pattern of Siren/Cirrus (every worker downloads every
other worker's full gradient) maps to an all-gather of *unreduced*
gradients followed by a local mean: O(n*|G|) bytes per worker instead of
O(|G|).

A 2-level variant maps SMLT's hierarchy onto a (pod, data) mesh:
reduce-scatter inside a pod, all-reduce of the small shards across pods,
all-gather inside the pod.

Every collective of the port goes through ``reduce_scatter``,
``all_gather`` and ``all_reduce`` here, which report it to
``launch/hlo_stats.py``'s recorders. Every rank calls these functions on
its own gradients (one process per
worker, where the reference runs inside ``shard_map``); ``group`` is the
process group of the mesh axis the reference names. The inputs are not
modified.
"""
from __future__ import annotations

import warnings
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import tree as T
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import axis_size

STRATEGIES = ("allreduce", "hier", "hier2", "hier2_q", "ps")


def reduce_scatter(out, inp, group):
    """Sum ``inp`` (n * k rows on every rank) over ``group``; ``out`` gets
    this rank's k rows. (``reduce_scatter_tensor`` is in every torch this
    port runs on; newer ones warn that it is deprecated.)"""
    hlo_stats.record("reduce-scatter", out)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, inp, group=group)
    return out


def all_gather(out, inp, group):
    """Concatenate every rank's ``inp`` along dim 0 into ``out``."""
    hlo_stats.record("all-gather", out)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, inp, group=group)
    return out


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """Sum (or ``op``) ``x`` over ``group`` in place."""
    hlo_stats.record("all-reduce", x)
    dist.all_reduce(x, op=op, group=group)
    return x


def _flat_pad(g, n: int):
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def allreduce_mean(grads, group, n: int):
    """Baseline: plain all-reduce mean."""
    def one(g):
        g = g.clone()
        all_reduce(g, group)
        return g / n
    return T.tree_map(one, grads)


def ps_mean(grads, group, n: int):
    """Siren/Cirrus centralized-store pattern: every worker gathers all n
    full gradients, then averages locally. O(n*|G|) ingress per worker."""
    def one(g):
        allg = torch.empty((n,) + tuple(g.shape), dtype=g.dtype,
                           device=g.device)
        all_gather(allg, g.unsqueeze(0).contiguous(), group)
        return torch.mean(allg, dim=0)
    return T.tree_map(one, grads)


def _scatter(g, group, n: int):
    flat, pad = _flat_pad(g, n)
    shard = torch.empty(flat.shape[0] // n, dtype=g.dtype, device=g.device)
    return reduce_scatter(shard, flat, group), flat.shape[0], pad


def _gather(shard, group, length: int, pad: int, shape):
    full = all_gather(torch.empty(length, dtype=shard.dtype,
                                  device=shard.device), shard, group)
    if pad:
        full = full[:length - pad]
    return full.reshape(shape)


def scatter_reduce_mean(grads, group, n: int):
    """SMLT hierarchical synchronization == reduce-scatter + all-gather."""
    def one(g):
        shard, length, pad = _scatter(g, group, n)
        return _gather(shard / n, group, length, pad, g.shape)
    return T.tree_map(one, grads)


def two_level_mean(grads, inner_group, outer_group, n_inner: int,
                   n_outer: int, *, compress_cross_pod: bool = False):
    """Pod-aware SMLT hierarchy: RS intra-pod, AR of shards across pods,
    AG intra-pod. Cross-pod traffic shrinks from |G| to |G|/n_inner per
    device pair.

    ``compress_cross_pod`` casts the (already intra-pod reduced) f32 shard
    to bf16 for the cross-pod hop, halving its bytes; the intra-pod math
    stays full precision."""
    def one(g):
        shard, length, pad = _scatter(g, inner_group, n_inner)
        if compress_cross_pod and shard.dtype == torch.float32:
            shard = shard.to(torch.bfloat16)
            all_reduce(shard, outer_group)
            shard = shard.float() / (n_inner * n_outer)
        else:
            all_reduce(shard, outer_group)
            shard = shard / (n_inner * n_outer)
        return _gather(shard, inner_group, length, pad, g.shape)
    return T.tree_map(one, grads)


def sync_grads(grads, strategy: str, *, data_group=None, pod_group=None,
               n_data: int = 1, n_pod: int = 1):
    """Dispatch on strategy name over the data (and pod) groups."""
    if strategy == "allreduce":
        if n_pod > 1:
            grads = allreduce_mean(grads, pod_group, 1)
            return allreduce_mean(grads, data_group, n_data * n_pod)
        return allreduce_mean(grads, data_group, n_data)
    if strategy == "hier":
        if n_pod > 1:
            return two_level_mean(grads, data_group, pod_group, n_data, n_pod)
        return scatter_reduce_mean(grads, data_group, n_data)
    if strategy == "hier2":
        assert n_pod > 1, "hier2 needs a pod axis"
        return two_level_mean(grads, data_group, pod_group, n_data, n_pod)
    if strategy == "hier2_q":
        assert n_pod > 1, "hier2_q needs a pod axis"
        return two_level_mean(grads, data_group, pod_group, n_data, n_pod,
                              compress_cross_pod=True)
    if strategy == "ps":
        if n_pod > 1:
            grads = allreduce_mean(grads, pod_group, n_pod)
        return ps_mean(grads, data_group, n_data)
    raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")


def _mean_loss(loss, mesh, *, data_axis: str = "data", pod_axis: str = "pod"):
    """The per-rank loss averaged over the data (then pod) axis."""
    loss = loss.detach().clone()
    for axis in (data_axis, pod_axis):
        if axis in mesh.mesh_dim_names:
            all_reduce(loss, mesh.get_group(axis))
            loss = loss / axis_size(mesh, axis)
    return loss


def make_sync_grad_fn(loss_fn: Callable, mesh, strategy: str,
                      *, data_axis: str = "data", pod_axis: str = "pod"):
    """Build f(params, local_batch) -> (loss, synced grads), called by
    every rank of ``mesh`` on its slice of the batch: the gradient of
    ``loss_fn(params, batch)`` on the slice, synchronized with
    ``strategy``, and the loss averaged over the data (x pod) ranks."""
    names = mesh.mesh_dim_names
    n_data = axis_size(mesh, data_axis)
    n_pod = axis_size(mesh, pod_axis)
    groups = dict(
        data_group=mesh.get_group(data_axis) if data_axis in names else None,
        pod_group=mesh.get_group(pod_axis) if pod_axis in names else None)
    grad_fn = T.value_and_grad(loss_fn)

    def local_step(params, batch):
        loss, grads = grad_fn(params, batch)
        grads = sync_grads(grads, strategy, n_data=n_data, n_pod=n_pod,
                           **groups)
        return _mean_loss(loss, mesh, data_axis=data_axis,
                         pod_axis=pod_axis), grads

    return local_step
