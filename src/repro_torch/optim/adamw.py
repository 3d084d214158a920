"""AdamW on nested-dict parameter trees (port of the JAX package's
``optim/adamw.py``).

Math in f32, cast back to each parameter's dtype: global-norm clip,
bias correction, decoupled weight decay. The moments are updated in place
(they belong to the optimizer state, and at full width a second copy of
them would cost as much as the model); parameters are returned as new
tensors, because stale workers may still hold the old ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import tree as T


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

    def update(self, grads, state: AdamWState, params, *, group=None,
               sharded=None):
        """-> (new params, state); ``state``'s moments are updated in place.

        Under sharded state (``launch/steps.py``'s ``hier``), the leaves
        that ``sharded`` (a tree of bools like ``grads``) flags hold this
        rank's shard of a tensor split over the process group ``group``;
        the clip's sum of their squares is summed over the group, so every
        rank clips by the global norm. The other leaves are replicated and
        counted once."""
        step = state.step + 1
        scale = None
        if self.grad_clip:
            sq = [torch.sum(torch.square(g.float())) for g in T.leaves(grads)]
            if group is None:
                total = sum(sq)
            else:
                flags = T.leaves(sharded)
                total = sum((x for x, f in zip(sq, flags) if f),
                            torch.zeros_like(sq[0]))
                dist.all_reduce(total, group=group)
                total = total + sum(x for x, f in zip(sq, flags) if not f)
            gnorm = torch.sqrt(total)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** float(step)
        bc2 = 1 - b2 ** float(step)
        lr = self.lr * (self.schedule(step) if self.schedule else 1.0)

        def upd(p, g, m, v):
            g = g.float() if scale is None else g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            pf = p.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) \
                + self.weight_decay * pf
            return (pf - lr * delta).to(p.dtype)

        new_params = T.tree_map(upd, params, grads, state.mu, state.nu)
        return new_params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def apply_sgd(params, grads, lr: float):
    """Plain SGD used by the semantic serverless trainer."""
    return T.tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
