"""Elastic rescaling (paper Section 3.1: scale adaptation on the fly); port
of the JAX package's ``core/elastic.py``.

On a serverless platform SMLT changes the worker fleet between epochs;
here that is rebuilding the step on a 1-D ``data`` mesh over the first n
ranks of the process group and moving the state onto it. The reference
lets ``device_put`` reshard; in the port every rank of the new mesh takes
rank 0's state by a broadcast, so a rank that joins on a scale-up starts
from the current params and optimizer state, not from what it held when
it last left.

Every rank of the default group runs the same calls (a mesh is built by
all of them together); a rank outside the current mesh idles through
``train_step``.
"""
from __future__ import annotations

from typing import Callable

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import tree as T
from repro_torch.optim.adamw import AdamWState


def make_data_mesh(n_workers: int, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D ``data`` mesh over ranks 0..n_workers-1 of the default group.
    Every rank calls it; the others get a mesh they are not in."""
    return DeviceMesh(device_type, list(range(n_workers)),
                      mesh_dim_names=("data",))


def in_mesh(mesh: DeviceMesh) -> bool:
    return mesh.get_coordinate() is not None


def reshard(tree, mesh: DeviceMesh):
    """Rank 0's ``tree`` (nested dicts of tensors, or an ``AdamWState``) on
    every rank of ``mesh``, replicated, as fresh copies: the port's AdamW
    updates its moments in place, so nothing here aliases the input. A
    rank outside the mesh keeps ``tree``."""
    if not in_mesh(mesh):
        return tree
    group = mesh.get_group("data")
    if isinstance(tree, AdamWState):
        step = [tree.step]
        dist.broadcast_object_list(step, src=0, group=group)
        return AdamWState(step=step[0], mu=reshard(tree.mu, mesh),
                          nu=reshard(tree.nu, mesh))

    def put(x):
        x = x.detach().clone()
        dist.broadcast(x, src=0, group=group)
        return x
    return T.tree_map(put, tree)


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's contiguous rows (dim 0) of a global batch."""
    n = mesh.size()
    i = mesh.get_coordinate()[0]
    return T.tree_map(lambda x: x[i * (x.shape[0] // n):
                                  (i + 1) * (x.shape[0] // n)], batch)


class ElasticRunner:
    """Owns (params, opt_state) and can rescale the worker fleet between
    epochs while training continues — the semantic core of SMLT
    adaptation. ``step_builder(mesh)`` returns ``step(params, opt_state,
    local_batch) -> (params, opt_state, loss)``."""

    def __init__(self, step_builder: Callable, params, opt_state,
                 n_workers: int, device_type: str = "cuda"):
        self._builder = step_builder
        self._device_type = device_type
        self.mesh = make_data_mesh(n_workers, device_type)
        self.params = reshard(params, self.mesh)
        self.opt_state = reshard(opt_state, self.mesh)
        self.step = step_builder(self.mesh) if in_mesh(self.mesh) else None
        self.n_workers = n_workers
        self.rescale_events = []

    def rescale(self, n_workers: int):
        if n_workers == self.n_workers:
            return
        self.mesh = make_data_mesh(n_workers, self._device_type)
        self.params = reshard(self.params, self.mesh)
        self.opt_state = reshard(self.opt_state, self.mesh)
        self.step = (self._builder(self.mesh) if in_mesh(self.mesh)
                     else None)
        self.rescale_events.append((self.n_workers, n_workers))
        self.n_workers = n_workers

    def train_step(self, batch):
        """One step on this rank's rows of the global ``batch``; the loss
        (None on a rank outside the mesh)."""
        if self.step is None:
            return None
        self.params, self.opt_state, loss = self.step(
            self.params, self.opt_state, shard_batch(batch, self.mesh))
        return loss
