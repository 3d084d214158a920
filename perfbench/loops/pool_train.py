"""SMLT's Fig. 5 training step: ``LocalWorkerPool`` (each worker's
forward and backward on its rows, the gradients sharded and aggregated
through the parameter store) and then ``AdamW.update``, back to back."""
from __future__ import annotations

import torch

from perfbench.loops.training import TrainLoop, check, control  # noqa: F401


class Loop(TrainLoop):
    def _build(self, w):
        from repro_torch.core import tree as T
        from repro_torch.models import registry
        from repro_torch.optim import AdamW
        from repro_torch.serverless import LocalWorkerPool, ParamStore
        t, cfg = self.ctx.cell.traffic, self.ctx.cfg
        vg = T.value_and_grad(lambda p, b: registry.loss_fn(p, cfg, b))
        self._losses = None

        def grad_fn(p, b):
            loss, g = vg(p, b)
            if self._losses is not None:
                self._losses.append(loss)
            return g
        self.pool = LocalWorkerPool(
            grad_fn, t["workers"], ParamStore(), use_kernel=t["use_kernel"],
            plan=t["plan"], sync_mode=t["sync_mode"])
        self.opt = AdamW(**t["optimizer"])
        self.params = w
        self.state = self.opt.init(w)

    def _train(self, batch, record: bool):
        spans = self.ctx.spans
        self._losses = [] if record else None
        with spans("pool.step"):
            grads = self.pool.step(self.params, batch)
        with spans("adamw.update"):
            self.params, self.state = self.opt.update(grads, self.state,
                                                      self.params)
        del grads
        if record:
            loss = torch.stack(self._losses).mean()
            self._losses = None
            return loss

    def _moments(self):
        return self.state.mu

    def _params(self):
        return self.params

    def release(self):
        self.pool = self.opt = self.params = self.state = None
