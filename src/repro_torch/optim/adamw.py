"""AdamW on nested-dict parameter trees (port of the JAX package's
``optim/adamw.py``).

Math in f32, cast back to each parameter's dtype: global-norm clip,
bias correction, decoupled weight decay. The moments are updated in place
(they belong to the optimizer state, and at full width a second copy of
them would cost as much as the model); parameters are returned as new
tensors, because stale workers may still hold the old ones. Each leaf's
sum of squares and update run in ``kernels/adamw.py``: one kernel launch
each on a CUDA leaf, the plain PyTorch version on a CPU leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import tree as T
from repro_torch.core.hier_sync import all_reduce
from repro_torch.core.spans import span
from repro_torch.kernels import adamw as kernel


@dataclasses.dataclass
class AdamWState:
    step: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    schedule: Optional[Callable] = None  # step -> lr multiplier

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return AdamWState(step=0, mu=T.tree_map(zeros, params),
                          nu=T.tree_map(zeros, params))

    def update(self, grads, state: AdamWState, params, *, sharded=None):
        """-> (new params, state); ``state``'s moments are updated in place.

        Under sharded state (``launch/steps.py``'s ``hier``, ZeRO-3 and
        tensor-parallel steps), ``sharded`` (a tree like ``grads``) gives
        each leaf that holds this rank's part of a tensor the process group
        it is split over (a tuple of groups, e.g. data and model, where it
        is split over several), and None for a replicated leaf. The clip's
        sum of squares of the split leaves is summed over each group, so
        every rank clips by the global norm; the replicated leaves are
        counted once. The whole call, clip included, is the span
        ``adamw.update`` (``core/spans.py``)."""
        with span("adamw.update"):
            return self._update(grads, state, params, sharded)

    def _update(self, grads, state: AdamWState, params, sharded):
        step = state.step + 1
        scale = None
        if self.grad_clip:
            sq = [kernel.sum_squares(g) for g in T.leaves(grads)]
            groups = [None if g is None else g if isinstance(g, tuple)
                      else (g,) for g in (T.leaves(sharded) if sharded
                                          is not None else [None] * len(sq))]
            # a group is its ranks: two handles on one group sum as one
            keys = [None if g is None else tuple(
                tuple(dist.get_process_group_ranks(x)) for x in g)
                for g in groups]
            total = torch.zeros_like(sq[0])
            for key in dict.fromkeys(k for k in keys if k is not None):
                part = sum((x for x, k in zip(sq, keys) if k == key),
                           torch.zeros_like(sq[0]))
                for g in groups[keys.index(key)]:
                    part = all_reduce(part, g)
                total = total + part
            total = total + sum(x for x, k in zip(sq, keys) if k is None)
            gnorm = torch.sqrt(total)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** float(step)
        bc2 = 1 - b2 ** float(step)
        lr = self.lr * (self.schedule(step) if self.schedule else 1.0)

        def upd(p, g, m, v):
            return kernel.adamw_update(
                p, g, m, v, scale, lr=lr, b1=b1, b2=b2, bc1=bc1, bc2=bc2,
                eps=self.eps, weight_decay=self.weight_decay)

        new_params = T.tree_map(upd, params, grads, state.mu, state.nu)
        return new_params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def apply_sgd(params, grads, lr: float):
    """Plain SGD used by the semantic serverless trainer."""
    return T.tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
