"""The ``hier`` training step of ``launch/steps.py`` (reduce-scatter of
the gradient, AdamW on this rank's shard, all-gather), as
``launch/train.py`` runs it, on a process group of the run's one rank."""
from __future__ import annotations

import contextlib

from perfbench.loops.training import TrainLoop, check, control  # noqa: F401


class Loop(TrainLoop):
    def _build(self, w):
        from repro_torch.launch.mesh import process_group
        from repro_torch.launch.steps import make_train_step
        from repro_torch.launch.train import make_local_mesh
        from repro_torch.optim import AdamW
        t, dev = self.ctx.cell.traffic, self.ctx.device
        self._group = contextlib.ExitStack()
        self._group.enter_context(process_group(dev))
        self.step_fn = make_train_step(
            self.ctx.cfg, make_local_mesh(dev), strategy=t["strategy"],
            optimizer=AdamW(**t["optimizer"]))
        self.params = self.step_fn.shard_params(w)
        self.state = self.step_fn.init_opt_state(self.params)

    def _train(self, batch, record: bool):
        with self.ctx.spans("train.step"):
            self.params, self.state, loss = self.step_fn(
                self.params, self.state, self.step_fn.local_batch(batch))
        return loss

    def _moments(self):
        return self.state.mu

    def _params(self):
        return self.step_fn.gather_params(self.params)

    def release(self):
        self.step_fn = self.params = self.state = None
        self._group.close()
