"""Scoring, checked on what the timed call itself produced: as ``score``,
``models.registry.loss_fn`` under ``no_grad``, one evaluation of ``batch``
x ``seq`` seeded tokens after another, but each call also hands back,
from the same pass, every row's mean loss and the logits at ``positions``
seeded positions of each row (``batch["logit_positions"]``).

What is compared, for ``checked`` evaluations sampled from the seed,
against the reference over the same rows: ``logit_gap``, the widest gap
between the program's and the reference's logits at those positions, in
units of the reference logits' root mean square there (random weights
give logits of a few hundredths, whose loss barely moves from ln V: the
loss alone does not tell a lower precision apart, the logits do); and
``row_loss_gap``, the widest relative gap of a row's mean loss."""
from __future__ import annotations

import torch

from perfbench import yardstick
from perfbench.loops import score as S
from perfbench.loops.training import weights
from perfbench.reference import common as C


def positions(ctx):
    """(batch, positions) seeded positions of the rows' logits, the same
    in every evaluation of a run."""
    t = ctx.cell.traffic
    return torch.tensor(
        [[yardstick.derive(ctx.seed, "position", r, j) % (t["seq"] - 1)
          for j in range(t["positions"])] for r in range(t["batch"])],
        device=ctx.device)


class Loop(S.Loop):
    def __init__(self, ctx):
        self.pos = positions(ctx)
        self.rows, self.logits = [], []
        super().__init__(ctx)

    def _score(self, x):
        with torch.no_grad(), self.ctx.spans("loss_fn"):
            return self.registry.loss_fn(
                self.params, self.ctx.cfg,
                {"tokens": x, "labels": x, "logit_positions": self.pos})

    def step(self, i: int):
        loss, got = self._score(S.tokens(self.ctx, "eval", i))
        self.losses.append(loss)
        self.rows.append(got["row_loss"])
        self.logits.append(got["logits"])

    def outputs(self) -> dict:
        """The sampled evaluations (drawn from the seed), each row's mean
        loss and the logits at the positions, as the timed calls gave
        them."""
        picks = S.Loop.outputs(self)["index"]
        return {"index": picks,
                "row_loss": [self.rows[i].double() for i in picks],
                "logits": [self.logits[i] for i in picks]}

    def release(self):
        super().release()
        self.rows = self.logits = None


def _reference(ctx, idx, precision: str):
    w, m, pos = weights(ctx), ctx.cell.config["model"], positions(ctx)
    out = [ctx.reference.sampled(w, m, S.tokens(ctx, "eval", i), pos,
                                 C.matmul(precision)) for i in idx]
    return [r for r, _ in out], [lg for _, lg in out]


def _gaps(rows, logits, ref_rows, ref_logits) -> dict:
    ref = torch.stack([x.float() for x in ref_logits])
    got = torch.stack([x.float() for x in logits])
    scale = float(torch.sqrt(torch.mean(ref * ref)))
    row = max(float(((g.double() - r) / r).abs().max())
              for g, r in zip(rows, ref_rows))
    return {"logit_gap": float((got - ref).abs().max()) / scale,
            "row_loss_gap": row}


def check(ctx, outputs: dict) -> dict:
    return _gaps(outputs["row_loss"], outputs["logits"],
                 *_reference(ctx, outputs["index"], "f32"))


def control(ctx, outputs: dict, variant: str) -> dict:
    """fp8 matmuls in the reference, in the program's place."""
    if variant != "fp8":
        raise ValueError(variant)
    return _gaps(*_reference(ctx, outputs["index"], "fp8"),
                 *_reference(ctx, outputs["index"], "f32"))
