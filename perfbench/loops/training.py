"""What the two training loops share. Set-up makes the weights, builds the
program's training step with its model and AdamW state, and drives that
step through its first ``checked_steps`` steps on the window's own feed;
the window goes on from there with the same objects. Those first steps
are what is compared: each step's loss, the first gradient as AdamW got
it (its first moment after one step over 1 - b1), and the parameters'
change after the checked steps, each leaf's norm against the reference's
(``yardstick.worst_leaf_gap``)."""
from __future__ import annotations

import torch

from perfbench import yardstick
from perfbench.reference import common as C


def weights(ctx):
    m = ctx.cell.config["model"]
    return C.make_weights(ctx.reference.spec(m), ctx.seed, ctx.device,
                          getattr(torch, m["dtype"]))


def batch(ctx, k: int):
    """The token rows of training step k (labels are the tokens)."""
    t, m = ctx.cell.traffic, ctx.cell.config["model"]
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(yardstick.derive(ctx.seed, "batch", k))
    tokens = torch.randint(0, m["vocab_size"], (t["batch"], t["seq"]),
                           generator=gen, device=ctx.device)
    return {"tokens": tokens, "labels": tokens}


class TrainLoop:
    """A subclass builds the program's step in ``_build(weights)`` and runs
    one in ``_train(batch, record)`` (returning the loss when recording),
    and hands AdamW's first moments to ``_moments()``."""

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.cell.traffic
        self.tokens = t["batch"] * t["seq"]
        self.b1 = t["optimizer"]["b1"]
        self.n_checked = t["checked_steps"]
        self._build(weights(ctx))
        losses, first = [], None
        for k in range(self.n_checked):
            losses.append(self._train(batch(ctx, k), record=True))
            if k == 0:
                first = self._norms(self._moments(), 1.0 / (1 - self.b1))
        w0 = dict(C.leaves_with_path(weights(ctx)))
        self._outputs = {
            "loss": [float(x) for x in losses], "first_grad": first,
            "change": {p: float(torch.linalg.vector_norm(
                x.float() - w0[p].float()))
                for p, x in C.leaves_with_path(self._params())}}
        del w0
        self.units = 0

    @staticmethod
    def _norms(tree, scale: float):
        return {p: float(torch.linalg.vector_norm(x.float())) * scale
                for p, x in C.leaves_with_path(tree)}

    def step(self, i: int):
        self._train(batch(self.ctx, self.n_checked + i), record=False)
        self.units = i + 1

    def boundary(self, units: int) -> bool:
        return True

    def window_metrics(self, window_s: float, units: int) -> dict:
        return {"train_tokens_per_s": units * self.tokens / window_s}

    def counters(self) -> dict:
        t = self.ctx.cell.traffic
        keys = self.units * t["batch"] * yardstick.causal_keys(t["seq"])
        return {"work": {"train": {"tokens": self.units * self.tokens,
                                   "keys": keys}}}

    def attempted(self) -> int:
        return self.units

    def outputs(self) -> dict:
        return self._outputs


def numbers(prog: dict, ref: dict) -> dict:
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": yardstick.worst_leaf_gap(prog["first_grad"],
                                             ref["first_grad"]),
        "change_gap": yardstick.worst_leaf_gap(
            prog["change"], ref["change"],
            yardstick.moved_leaves(ref["first_grad"]))}


def reference(ctx, precision: str = "f32", fault=None) -> dict:
    t = ctx.cell.traffic
    return ctx.reference.train_readings(
        weights(ctx), ctx.cell.config["model"],
        [batch(ctx, k)["tokens"] for k in range(t["checked_steps"])],
        t["optimizer"], C.matmul(precision), fault=fault,
        n_workers=t.get("workers", 1))


def check(ctx, outputs: dict) -> dict:
    return numbers(outputs, reference(ctx))


def control(ctx, outputs: dict, variant: str) -> dict:
    """The numbers of the reference put in the program's place: computed
    with fp8 matmuls ("fp8"), or with a planted fault ("half",
    "no_exchange"; ``reference.train_readings``)."""
    ref = reference(ctx)
    if variant == "fp8":
        return numbers(reference(ctx, "fp8"), ref)
    return numbers(reference(ctx, fault=variant), ref)
