"""Serving with one client, a closed loop: ``ServingEngine.serve_batch``
on ``batch`` requests that share a prompt length, the lengths in the
fixed cycle ``prompt_lens``, each request ``new_tokens`` greedy tokens.
A request is timed from its batch's submission to its completion; the
window ends with a whole cycle.

What is compared: for a sample of the completed requests drawn from the
seed, one of the longest among them, the widest gap by which a served
token's logit lies below the reference's best at its position, the
reference running once over the prompt and the served tokens."""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import yardstick
from perfbench.loops.training import weights
from perfbench.reference import common as C


def prompts(ctx, i: int) -> np.ndarray:
    """The prompts of batch i, (batch, length of the cycle's i-th)."""
    t, m = ctx.cell.traffic, ctx.cell.config["model"]
    plen = t["prompt_lens"][i % len(t["prompt_lens"])]
    rng = np.random.Generator(np.random.PCG64(
        yardstick.derive(ctx.seed, "prompt", i)))
    return rng.integers(0, m["vocab_size"], (t["batch"], plen),
                        dtype=np.int32)


class Loop:
    def __init__(self, ctx):
        from repro_torch.serving import Request, ServingEngine
        self.ctx, self.Request = ctx, Request
        self.t = ctx.cell.traffic
        self.engine = ServingEngine(ctx.cfg, params=weights(ctx),
                                    device=ctx.device)
        for plen in self.t["prompt_lens"]:      # each prefill shape, decode
            x = np.zeros((self.t["batch"], plen), dtype=np.int32)
            self.engine.serve_batch([Request(r, x[r], 2)
                                     for r in range(len(x))])
        self.latency, self.done = [], []
        self.sums = dict(prefill_s=0.0, decode_s=0.0, decode_steps=0,
                         prompt_tokens=0, new_tokens=0, requests=0)
        self.work = {k: {"tokens": 0, "keys": 0}
                     for k in ("prefill", "head", "decode")}

    def step(self, i: int):
        x = prompts(self.ctx, i)
        n = self.t["new_tokens"]
        reqs = [self.Request(i * len(x) + r, x[r], n) for r in range(len(x))]
        t0 = _now()
        with self.ctx.spans("serve_batch"):
            out = self.engine.serve_batch(reqs)
        dt = _now() - t0
        st = self.engine.last_stats
        s = self.sums
        s["prefill_s"] += st["prefill_s"]
        s["decode_s"] += st["decode_s"]
        s["decode_steps"] += st["new_tokens"] - 1
        s["prompt_tokens"] += x.size
        s["new_tokens"] += sum(len(c.tokens) for c in out)
        s["requests"] += len(out)
        w, b, plen, steps = self.work, len(x), x.shape[1], st["new_tokens"] - 1
        w["prefill"]["tokens"] += b * plen
        w["prefill"]["keys"] += b * yardstick.causal_keys(plen)
        w["head"]["tokens"] += b            # the prefill's last position
        w["decode"]["tokens"] += b * steps  # step j attends plen + j keys
        w["decode"]["keys"] += b * (steps * plen + steps * (steps + 1) // 2)
        self.latency += [dt] * len(out)
        self.done.append([c.tokens for c in out])

    def boundary(self, units: int) -> bool:
        return units % len(self.t["prompt_lens"]) == 0

    def window_metrics(self, window_s: float, units: int) -> dict:
        return {"serve_tokens_per_s": self.sums["new_tokens"] / window_s}

    def counters(self) -> dict:
        lat = sorted(self.latency)
        return dict(self.sums, work=self.work,
                    request_s_p95=lat[math.ceil(0.95 * len(lat)) - 1])

    def attempted(self) -> int:
        return self.sums["requests"]

    def outputs(self) -> dict:
        """A sample of (batch, row, served tokens): a request of the
        longest prompt, then others, all drawn from the seed."""
        lens = self.t["prompt_lens"]
        b, seed = self.t["batch"], self.ctx.seed
        longest = [i for i in range(len(self.done))
                   if lens[i % len(lens)] == max(lens)]
        picks = [(longest[yardstick.derive(seed, "long") % len(longest)],
                  yardstick.derive(seed, "long_row") % b)]
        j = 0
        while len(picks) < self.t["checked"]:
            k = yardstick.derive(seed, "sample", j) % (len(self.done) * b)
            if (k // b, k % b) not in picks:
                picks.append((k // b, k % b))
            j += 1
        return {"picks": [(i, r, self.done[i][r].tolist())
                          for i, r in picks]}

    def release(self):
        self.engine = None


def _now():
    import time
    return time.perf_counter()


def _gaps(ctx, outputs, precision: str):
    """The widest gap, over the sampled requests' served positions, by
    which a token's reference logit lies below the reference's best: of
    the served token, or, for a lower ``precision``, of the token that
    precision puts first."""
    m = ctx.cell.config["model"]
    w = weights(ctx)
    worst = 0.0
    for i, r, served in outputs["picks"]:
        prompt = torch.from_numpy(prompts(ctx, i)[r]).to(ctx.device)
        toks = torch.tensor(served, device=ctx.device)
        ref = ctx.reference.served_logits(w, m, prompt, toks,
                                          C.matmul("f32"))
        if precision != "f32":
            low = ctx.reference.served_logits(w, m, prompt, toks,
                                              C.matmul(precision))
            toks = low.argmax(-1)
        gap = ref.max(-1).values - ref.gather(-1, toks[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def check(ctx, outputs: dict) -> dict:
    return {"logit_gap": _gaps(ctx, outputs, "f32")}


def control(ctx, outputs: dict, variant: str) -> dict:
    """At each position of the same prompts and served tokens, the gap of
    the token that fp8 matmuls put first."""
    if variant != "fp8":
        raise ValueError(variant)
    return {"logit_gap": _gaps(ctx, outputs, "fp8")}
