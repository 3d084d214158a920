"""Scoring: ``models.registry.loss_fn`` under ``no_grad``, one evaluation
of ``batch`` x ``seq`` seeded tokens after another. What is compared is
the loss of ``checked`` evaluations sampled from the seed, the program's
answers, against the reference's losses over the same rows: their
relative gaps, averaged."""
from __future__ import annotations

import torch

from perfbench import yardstick
from perfbench.loops.training import weights
from perfbench.reference import common as C


def tokens(ctx, key: str, k: int):
    t, m = ctx.cell.traffic, ctx.cell.config["model"]
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(yardstick.derive(ctx.seed, key, k))
    return torch.randint(0, m["vocab_size"], (t["batch"], t["seq"]),
                         generator=gen, device=ctx.device)


class Loop:
    def __init__(self, ctx):
        from repro_torch.models import registry
        self.ctx, self.registry = ctx, registry
        t = ctx.cell.traffic
        self.tokens = t["batch"] * t["seq"]
        self.params = weights(ctx)
        for k in range(t["warmup"]):
            self._score(tokens(ctx, "warmup", k))
        self.losses = []

    def _score(self, x):
        with torch.no_grad(), self.ctx.spans("loss_fn"):
            return self.registry.loss_fn(self.params, self.ctx.cfg,
                                         {"tokens": x, "labels": x})

    def step(self, i: int):
        self.losses.append(self._score(tokens(self.ctx, "eval", i)))

    def boundary(self, units: int) -> bool:
        return True

    def window_metrics(self, window_s: float, units: int) -> dict:
        return {"score_tokens_per_s": units * self.tokens / window_s}

    def counters(self) -> dict:
        t, n = self.ctx.cell.traffic, len(self.losses)
        keys = n * t["batch"] * yardstick.causal_keys(t["seq"])
        return {"work": {"score": {"tokens": n * self.tokens, "keys": keys}}}

    def attempted(self) -> int:
        return len(self.losses)

    def outputs(self) -> dict:
        """The sampled evaluations (drawn from the seed) and their losses."""
        n = len(self.losses)
        picks = sorted({yardstick.derive(self.ctx.seed, "sample", j) % n
                        for j in range(self.ctx.cell.traffic["checked"])})
        return {"index": picks, "loss": [float(self.losses[i])
                                          for i in picks]}

    def release(self):
        self.params = self.losses = None


def _ref_loss(ctx, i: int, precision: str) -> float:
    s, n = ctx.reference.loss_sum(weights(ctx), ctx.cell.config["model"],
                                  tokens(ctx, "eval", i),
                                  C.matmul(precision))
    return s / n


def _mean_gap(got, ref) -> dict:
    """The sampled evaluations' relative loss gaps, averaged: each gap is
    rounding noise that swings from one evaluation to the next, and the
    mean of a few swings less than one."""
    gaps = [abs(g - r) / abs(r) for g, r in zip(got, ref)]
    return {"loss_gap": sum(gaps) / len(gaps)}


def check(ctx, outputs: dict) -> dict:
    return _mean_gap(outputs["loss"], [_ref_loss(ctx, i, "f32")
                                       for i in outputs["index"]])


def control(ctx, outputs: dict, variant: str) -> dict:
    """fp8 matmuls in the reference, in the program's place."""
    if variant != "fp8":
        raise ValueError(variant)
    idx = outputs["index"]
    return _mean_gap([_ref_loss(ctx, i, "fp8") for i in idx],
                     [_ref_loss(ctx, i, "f32") for i in idx])
