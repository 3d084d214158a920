"""Inference arrival processes for the event engine's serving jobs.

PAPER.md's loop is continuous — "models are continuously trained,
improved, and deployed" — so serving traffic must be a workload the
simulator can generate at production shape: a Poisson request stream
whose rate follows a diurnal cycle (reusing ``repro_torch.data.OnlineStream``,
the same process that drives the online-training experiment) with
flash-crowd bursts layered on top. At planet scale ("millions of users")
the stream is generated slice-by-slice with vectorized placement, not
one draw per request chain.

``ServingTask`` packages an arrival process with a serving policy into
the workflow layer's ``deploy`` task kind: the closed-form ``estimate()``
gives the budget allocator a forecast the same way ``epoch_estimate``
does for training tasks.

A copy of the JAX package's ``serverless/arrivals.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.rng import base_stream
from repro_torch.data.pipeline import OnlineStream
from repro_torch.serverless.platform import LAMBDA_GB_SECOND, LAMBDA_PER_REQUEST


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """A diurnal + bursty Poisson request process.

    ``base_rps`` is the diurnal-mean request rate; the rate swings by
    ``amplitude`` over ``period_s`` (the OnlineStream sine). Bursts are a
    Poisson process of flash-crowd episodes (``bursts_per_hour``): while
    one is active the instantaneous rate is multiplied by
    ``burst_multiplier`` for ``burst_s`` seconds."""
    base_rps: float
    period_s: float = 86_400.0
    amplitude: float = 0.5
    bursts_per_hour: float = 0.0
    burst_s: float = 60.0
    burst_multiplier: float = 3.0

    def mean_rps(self) -> float:
        """Long-run mean rate including the burst excess."""
        burst_frac = self.bursts_per_hour / 3600.0 * self.burst_s
        return self.base_rps * (1.0 + burst_frac
                                * (self.burst_multiplier - 1.0))

    def expected_requests(self, horizon_s: float) -> float:
        return self.mean_rps() * horizon_s


class RequestStream:
    """Samples concrete arrival timestamps from an :class:`ArrivalSpec`.

    Generation is sliced: per ``slice_s`` window the diurnal Poisson
    count comes from ``OnlineStream.arrivals`` (bit-compatible with the
    online-training stream), is scaled by any burst overlapping the
    slice, and the requests are placed uniformly inside the slice — one
    numpy call per slice, so a million-request day is cheap."""

    def __init__(self, spec: ArrivalSpec, seed: int = 0):
        self.spec = spec
        self.seed = seed

    def rate(self, t: float) -> float:
        """Deterministic diurnal rate (bursts excluded)."""
        s = self.spec
        return max(s.base_rps * (1.0 + s.amplitude
                                 * np.sin(2 * np.pi * t / s.period_s)), 0.0)

    def _burst_windows(self, t0: float, horizon_s: float,
                       rng: np.random.RandomState) -> list:
        s = self.spec
        if s.bursts_per_hour <= 0.0:
            return []
        out, t = [], t0
        while True:
            t += float(rng.exponential(3600.0 / s.bursts_per_hour))
            if t >= t0 + horizon_s:
                return out
            out.append((t, t + s.burst_s))

    def arrivals(self, t0: float = 0.0, horizon_s: float = 600.0,
                 slice_s: float = 1.0) -> np.ndarray:
        """Sorted arrival offsets in ``[0, horizon_s)`` (relative to
        ``t0``; ``t0`` only phases the diurnal cycle)."""
        s = self.spec
        diurnal = OnlineStream(s.base_rps, seed=self.seed,
                               period_s=s.period_s, amplitude=s.amplitude)
        rng = base_stream(self.seed + 1)
        bursts = self._burst_windows(t0, horizon_s, rng)
        chunks = []
        lo = t0
        while lo < t0 + horizon_s:
            dt = min(slice_s, t0 + horizon_s - lo)
            k = diurnal.arrivals(lo, dt)
            # burst excess: extra Poisson mass proportional to overlap
            overlap = sum(max(min(hi_b, lo + dt) - max(lo_b, lo), 0.0)
                          for lo_b, hi_b in bursts)
            if overlap > 0.0:
                extra = self.rate(lo + dt / 2) * overlap \
                    * (s.burst_multiplier - 1.0)
                k += int(rng.poisson(extra))
            if k:
                chunks.append(rng.uniform(lo - t0, lo - t0 + dt, size=k))
            lo += dt
        if not chunks:
            return np.empty(0, dtype=float)
        return np.sort(np.concatenate(chunks))


@dataclasses.dataclass(frozen=True)
class ServingTask:
    """The workflow-layer spec of one ``deploy`` task: serve ``arrivals``
    for ``duration_s`` under ``policy`` on an autoscaled serverless
    fleet. ``model_bytes`` is fetched from the ParamStore on every cold
    start (and every ``refresh_every_s`` — continuous deployment serves
    the *current* model), ``code_bytes`` from the ObjectStore; both ride
    the engine's shared links, so a deployed model contends with the
    training that produces its successor. ``link_priority`` is the
    water-filling priority of the serving fetches on those links."""
    policy: "object"                 # repro_torch.serving.ServePolicy
    arrivals: ArrivalSpec
    duration_s: float
    flops_per_request: float
    model_bytes: float = 0.0
    code_bytes: float = 0.0
    slo_s: Optional[float] = None
    cold_start_s: float = 1.0
    keep_warm_s: float = 60.0
    max_instances: int = 64
    refresh_every_s: Optional[float] = None
    link_priority: float = 1.0

    def estimate(self) -> Tuple[float, float]:
        """Closed-form (wall_s, cost_usd) forecast for the allocator —
        the serving analogue of ``epoch_estimate``."""
        from repro_torch.serving.batcher import exec_time
        pol = self.policy
        n_req = max(self.arrivals.expected_requests(self.duration_s), 1.0)
        rate = self.arrivals.mean_rps()
        # mean batch: bounded by the batch cap and by what a timeout
        # window collects at this rate
        mean_batch = min(float(pol.max_batch),
                         max(rate * pol.timeout_s, 1.0))
        batches = n_req / mean_batch
        dt = exec_time(self.flops_per_request, int(round(mean_batch)),
                       pol.memory_mb)
        gb_s = batches * pol.memory_mb / 1024.0 * dt
        cost = gb_s * LAMBDA_GB_SECOND + batches * LAMBDA_PER_REQUEST
        # the tail drains within one timeout + one execution past the
        # last arrival
        wall = self.duration_s + pol.timeout_s + dt
        return wall, cost
