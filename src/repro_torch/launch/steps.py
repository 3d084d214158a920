"""The training step over a ``torch.distributed`` mesh (port of the JAX
package's ``launch/steps.py::make_train_step``).

The SMLT synchronization strategy is a first-class knob of the step:

  "allreduce" — every gradient is all-reduced over the data (x pod) ranks
                and every rank applies the whole update (the naive
                baseline);
  "hier"      — SMLT's hierarchical ScatterReduce: each gradient leaf that
                the sharding rules split over ``data`` is reduce-scattered
                along that dim, the optimizer runs on this rank's shard
                only (its moments are held for the shard alone: ZeRO-style
                state, each worker the paper's shard aggregator), and the
                updated shards are all-gathered. On a (pod, data) mesh the
                scatter and gather stay inside a pod and the shards are
                all-reduced across pods: the 2-level hierarchy;
  "hier1"     — the flat 1-level variant over (pod, data) jointly.

Leaves the rules leave unsplit (small or indivisible) are all-reduced, and
their update is replicated. Each rank computes the gradient of
``registry.loss_fn`` on its contiguous slice of the global batch; the
loss is the mean of the ranks' losses, which is the global batch's mean
when the slices are equal and no label is masked (-1), as in the data
stream here. The collectives run at every world size, one included.

Not ported yet: ``fsdp=True`` (ZeRO-3 parameters) and a ``model`` axis >
1 (tensor parallelism) raise, and so do the prefill and serve steps
(ROADMAP A16). Where the reference spreads the ``hier`` optimizer state
over pod x data, the port's is split over ``data`` and replicated across
pods.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core import tree as T
from repro_torch.core.hier_sync import all_gather, reduce_scatter
from repro_torch.distributed.sharding import param_specs, placement
from repro_torch.launch.mesh import (axis_size, data_axes, data_group,
                                     data_index, data_size)
from repro_torch.models import registry
from repro_torch.models.base import ModelConfig
from repro_torch.optim.adamw import AdamW, AdamWState


def _grad_axes(mesh, strategy: str):
    if strategy == "hier":
        return "data"
    if strategy == "hier1":
        return data_axes(mesh)
    if strategy == "allreduce":
        return None
    raise ValueError(f"unknown train sync strategy {strategy!r}")


@dataclasses.dataclass
class _Shard:
    """One leaf split along ``dim`` into ``n`` parts over ``group``; this
    rank holds part ``index``. ``pod_group`` (``hier`` on a pod mesh) sums
    the reduced shard across pods."""
    dim: int
    group: Any
    n: int
    index: int
    pod_group: Any = None

    def take(self, x):
        """This rank's part of a full tensor (a view)."""
        k = x.shape[self.dim] // self.n
        return x.narrow(self.dim, self.index * k, k)

    def scatter(self, g):
        """The summed gradient's part for this rank, in g's layout."""
        moved = g.movedim(self.dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // self.n,) + moved.shape[1:],
                          dtype=g.dtype, device=g.device)
        reduce_scatter(out, moved, self.group)
        if self.pod_group is not None:
            dist.all_reduce(out, group=self.pod_group)
        return out.movedim(0, self.dim)

    def gather(self, part):
        """Every rank's part, concatenated back along ``dim``."""
        moved = part.movedim(self.dim, 0).contiguous()
        out = torch.empty((moved.shape[0] * self.n,) + moved.shape[1:],
                          dtype=part.dtype, device=part.device)
        return all_gather(out, moved, self.group).movedim(0, self.dim) \
            .contiguous()


@dataclasses.dataclass
class TrainStep:
    """``step(params, opt_state, local_batch) -> (params, opt_state,
    loss)``, called by every rank of the mesh with its rows of the global
    batch (``local_batch``). Params are replicated; each split leaf's
    moments in ``opt_state`` hold this rank's part (``init_opt_state``,
    ``shard_opt_state`` and ``gather_opt_state`` move between that and the
    full state)."""
    cfg: ModelConfig
    optimizer: AdamW
    shards: List[Optional[_Shard]]       # per param leaf, in leaves order
    shard_group: Any                     # the group the shards split over
    group: Any                           # every data-like rank
    n_data: int
    index: int

    def local_batch(self, batch):
        """This rank's contiguous rows of a global batch (a tree of numpy
        arrays or tensors); a batch that does not divide stays whole."""
        def rows(x):
            b = x.shape[0]
            if b % self.n_data:
                return x
            k = b // self.n_data
            return x[self.index * k:(self.index + 1) * k]
        return T.tree_map(rows, batch)

    def _parts(self, tree):
        return T.unflatten(tree, [x if s is None else s.take(x)
                                  for x, s in zip(T.leaves(tree),
                                                  self.shards)])

    def init_opt_state(self, params) -> AdamWState:
        return self.optimizer.init(self._parts(params))

    def shard_opt_state(self, state: AdamWState) -> AdamWState:
        """A full optimizer state (a checkpoint's) -> this rank's parts,
        copied."""
        part = lambda t: T.tree_map(lambda x: x.clone(),  # noqa: E731
                                    self._parts(t))
        return AdamWState(step=state.step, mu=part(state.mu),
                          nu=part(state.nu))

    def gather_opt_state(self, state: AdamWState) -> AdamWState:
        """This rank's parts -> the full optimizer state, on every rank."""
        def full(t):
            return T.unflatten(t, [x.clone() if s is None else s.gather(x)
                                   for x, s in zip(T.leaves(t),
                                                   self.shards)])
        return AdamWState(step=state.step, mu=full(state.mu),
                          nu=full(state.nu))

    def __call__(self, params, opt_state: AdamWState, batch):
        loss, grads = T.value_and_grad(
            lambda p, b: registry.loss_fn(p, self.cfg, b))(params, batch)
        gl = T.leaves(grads)
        del grads
        for i, s in enumerate(self.shards):
            if s is None:
                dist.all_reduce(gl[i], group=self.group)
                gl[i] = gl[i] / self.n_data
            else:
                gl[i] = s.scatter(gl[i]) / self.n_data
        sharded = T.unflatten(params, [s is not None for s in self.shards])
        new_parts, opt_state = self.optimizer.update(
            T.unflatten(params, gl), opt_state, self._parts(params),
            group=self.shard_group, sharded=sharded)
        del gl
        new = [x if s is None else s.gather(x)
               for x, s in zip(T.leaves(new_parts), self.shards)]
        dist.all_reduce(loss, group=self.group)
        return T.unflatten(params, new), opt_state, loss / self.n_data


def make_train_step(cfg: ModelConfig, mesh, *, strategy: str = "hier",
                    fsdp: bool = False,
                    optimizer: Optional[AdamW] = None) -> TrainStep:
    """The training step of ``strategy`` over ``mesh`` (see the module
    docstring); every rank of the mesh builds it together."""
    if fsdp:
        raise NotImplementedError(
            "fsdp=True (ZeRO-3 parameters) is not ported yet (ROADMAP A16)")
    model_n = axis_size(mesh, "model")
    if model_n != 1:
        raise NotImplementedError(
            "a model axis > 1 (tensor parallelism) is not ported yet "
            "(ROADMAP A16)")
    opt = optimizer or AdamW(lr=3e-4)
    gaxes = _grad_axes(mesh, strategy)
    group = data_group(mesh)
    n_data = data_size(mesh)
    pshapes = registry.init(0, cfg, device="meta")
    shards = [None] * len(T.leaves(pshapes))
    g = None
    if gaxes:
        # the reference's ZeRO layout: gradients constrained to the
        # reduce-scatter placement of these specs
        zspecs = param_specs(pshapes, model_size=model_n, fsdp_axis=gaxes,
                             fsdp_min_size=2 ** 14,
                             fsdp_divisor=(n_data if strategy == "hier1"
                                           else axis_size(mesh, "data")))
        two_level = strategy == "hier" and axis_size(mesh, "pod") > 1
        g = mesh.get_group("data") if strategy == "hier" else group
        for i, spec in enumerate(T.leaves(zspecs)):
            where = placement(spec, model_n)
            if where is not None:
                shards[i] = _Shard(
                    dim=where[0], group=g, n=dist.get_world_size(g),
                    index=dist.get_rank(g),
                    pod_group=mesh.get_group("pod") if two_level else None)
    return TrainStep(cfg=cfg, optimizer=opt, shards=shards, shard_group=g,
                     group=group, n_data=n_data, index=data_index(mesh))
