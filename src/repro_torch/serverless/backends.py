"""Execution backends: where a job runs, as a typed searchable dimension.

`BackendSpec` carries the execution semantics that differ across
deployment targets — exactly like ``CommPlan`` did for communication:

- ``serverless``: per-request billing, 900 s duration cap, cold starts,
  instant elasticity. This is the repo's native target; a ``None`` (or
  ``"serverless"``) backend resolves to the legacy code path so
  serverless-only configs stay bit-identical.
- ``vm``: a provisioning delay of minutes replaces the cold start,
  per-second billing runs from the end of provisioning to teardown,
  there is no duration cap and no per-request fee.
- ``gpu_vm``: a VM with a high compute rate and a high $/s, optional
  spot tier priced by a `PriceTrace`.

Spot semantics: when the spot price crosses the bid, the spot subset is
preempted (a correlated shock in the event engine — in-flight work is
lost and the worker restarts from its last checkpoint). The
``spot_policy`` selects what happens next: ``"fallback"`` restarts
immediately on on-demand billing; ``"wait"`` sits out the spike unbilled
until the price drops back below the bid.

Checkpoint cadence under preemption is hazard-aware: the Young–Daly
interval ``sqrt(2 * ckpt_write_s / hazard)`` derived from the trace's
local preemption hazard rate instead of a constant (see
``hazard_cadence_s`` and ``docs/BACKENDS.md``).

A copy of the JAX package's ``serverless/backends.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# spot-price model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PriceTrace:
    """Piecewise-constant per-worker spot price.

    ``prices_usd_per_hr[i]`` holds from ``times_s[i]`` until
    ``times_s[i+1]`` (the last segment holds forever). Frozen and
    tuple-backed so it hashes cleanly into probe-cache keys.
    """
    times_s: Tuple[float, ...]
    prices_usd_per_hr: Tuple[float, ...]

    def __post_init__(self):
        if len(self.times_s) != len(self.prices_usd_per_hr):
            raise ValueError("times_s and prices_usd_per_hr length mismatch")
        if not self.times_s:
            raise ValueError("PriceTrace needs at least one segment")
        if self.times_s[0] != 0.0:
            raise ValueError("PriceTrace must start at t=0")
        if any(b <= a for a, b in zip(self.times_s, self.times_s[1:])):
            raise ValueError("times_s must be strictly increasing")
        if any(p < 0 for p in self.prices_usd_per_hr):
            raise ValueError("negative price")

    def _seg(self, t_s: float) -> int:
        return max(bisect.bisect_right(self.times_s, t_s) - 1, 0)

    def price_at(self, t_s: float) -> float:
        """$/hr per worker in effect at ``t_s``."""
        return self.prices_usd_per_hr[self._seg(t_s)]

    def next_crossing_above(self, t_s: float, bid_usd_per_hr: float) -> float:
        """Earliest time ``>= t_s`` at which the price exceeds the bid
        (``math.inf`` when it never does)."""
        i = self._seg(t_s)
        if self.prices_usd_per_hr[i] > bid_usd_per_hr:
            return t_s
        for j in range(i + 1, len(self.times_s)):
            if self.prices_usd_per_hr[j] > bid_usd_per_hr:
                return self.times_s[j]
        return math.inf

    def next_drop_below(self, t_s: float, bid_usd_per_hr: float) -> float:
        """Earliest time ``>= t_s`` at which the price is at or below the
        bid (``math.inf`` when it never recovers)."""
        i = self._seg(t_s)
        if self.prices_usd_per_hr[i] <= bid_usd_per_hr:
            return t_s
        for j in range(i + 1, len(self.times_s)):
            if self.prices_usd_per_hr[j] <= bid_usd_per_hr:
                return self.times_s[j]
        return math.inf

    def integral_usd(self, t0_s: float, t1_s: float) -> float:
        """Dollars one worker accrues over ``[t0_s, t1_s]`` at the trace
        price."""
        if t1_s <= t0_s:
            return 0.0
        usd = 0.0
        i = self._seg(t0_s)
        t = t0_s
        while t < t1_s:
            seg_end = (self.times_s[i + 1] if i + 1 < len(self.times_s)
                       else math.inf)
            span_s = min(t1_s, seg_end) - t
            usd += span_s / 3600.0 * self.prices_usd_per_hr[i]
            t += span_s
            i += 1
        return usd

    @property
    def mean_usd_per_hr(self) -> float:
        """Time-average price over the trace's defined span (the
        analytic estimate's expected spot rate)."""
        span_s = self.times_s[-1]
        if span_s <= 0.0:
            return self.prices_usd_per_hr[0]
        return self.integral_usd(0.0, span_s) * 3600.0 / span_s

    def hazard_per_s(self, bid_usd_per_hr: float, t0_s: float = 0.0,
                     horizon_s: float = 0.0) -> float:
        """Preemption hazard rate: up-crossings of the bid per second over
        ``[t0_s, t0_s + horizon_s)`` (the whole remaining trace when
        ``horizon_s`` is 0). An up-crossing at a segment boundary counts
        when the previous segment was at/below the bid."""
        end_s = (t0_s + horizon_s) if horizon_s > 0 else self.times_s[-1]
        if end_s <= t0_s:
            end_s = t0_s + 1.0
        crossings = 0
        prev_above = self.price_at(t0_s) > bid_usd_per_hr
        for j in range(self._seg(t0_s) + 1, len(self.times_s)):
            if self.times_s[j] >= end_s:
                break
            above = self.prices_usd_per_hr[j] > bid_usd_per_hr
            if above and not prev_above:
                crossings += 1
            prev_above = above
        return crossings / (end_s - t0_s)


def hazard_cadence_s(hazard_per_s: float, ckpt_write_s: float,
                     floor_s: float = 1.0) -> float:
    """Hazard-aware checkpoint interval (Young–Daly first-order optimum).

    ``tau* = sqrt(2 * ckpt_write_s / hazard)`` balances checkpoint
    overhead (``ckpt_write_s / tau``) against expected rework
    (``hazard * tau / 2``). Zero hazard means never checkpoint
    (``math.inf``)."""
    if hazard_per_s <= 0.0:
        return math.inf
    return max(math.sqrt(2.0 * ckpt_write_s / hazard_per_s), floor_s)


# ---------------------------------------------------------------------------
# backend specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Execution semantics of one deployment target.

    ``kind`` is ``"serverless"`` (per-request billing, duration cap,
    cold starts) or ``"vm"`` (provisioning delay, per-second billing
    from the end of provisioning, no cap, no request fee). VM kinds
    override the memory-derived compute rate and NIC with flat
    ``gflops`` / ``net_gbps``; a spot tier adds a `PriceTrace` and a
    bid."""
    name: str
    kind: str = "serverless"
    provision_s: float = 0.0           # replaces the cold start (vm kinds)
    usd_per_hr: float = 0.0            # on-demand $/hr per worker (vm kinds)
    gflops: Optional[float] = None     # None: memory-derived fn_gflops
    net_gbps: Optional[float] = None   # None: memory-derived fn_net_gbps
    spot: bool = False
    price_trace: Optional[PriceTrace] = None
    bid_usd_per_hr: float = 0.0
    spot_policy: str = "fallback"      # "fallback" (on-demand) | "wait"

    def __post_init__(self):
        if self.kind not in ("serverless", "vm"):
            raise ValueError(f"backend kind {self.kind!r}")
        if self.spot_policy not in ("fallback", "wait"):
            raise ValueError(f"spot_policy {self.spot_policy!r}")
        if self.spot and self.price_trace is None:
            raise ValueError("spot backend needs a price_trace")
        if self.spot and self.bid_usd_per_hr <= 0:
            raise ValueError("spot backend needs a positive bid")

    @property
    def capped(self) -> bool:
        return self.kind == "serverless"

    @property
    def usd_per_s(self) -> float:
        return self.usd_per_hr / 3600.0

    @property
    def expected_usd_per_s(self) -> float:
        """The rate the analytic estimate bills at: the on-demand rate,
        or the trace's time-average for spot tiers."""
        if self.spot and self.price_trace is not None:
            return self.price_trace.mean_usd_per_hr / 3600.0
        return self.usd_per_s

    def gflops_for(self, memory_mb: float) -> float:
        if self.gflops is not None:
            return self.gflops
        from repro_torch.serverless.platform import fn_gflops
        return fn_gflops(memory_mb)

    def net_gbps_for(self, memory_mb: float) -> float:
        if self.net_gbps is not None:
            return self.net_gbps
        from repro_torch.serverless.platform import fn_net_gbps
        return fn_net_gbps(memory_mb)


# Registry of named targets. Rates follow the paper-era AWS price book
# already used by the VM baselines in ``core/cost_model.py``
# (c5.2xlarge-class CPU VM) plus a single-accelerator GPU instance
# (p3.2xlarge-class).
BACKENDS: Dict[str, BackendSpec] = {
    "serverless": BackendSpec("serverless", "serverless"),
    "vm": BackendSpec("vm", "vm", provision_s=120.0, usd_per_hr=0.34,
                      gflops=360.0, net_gbps=1.25),
    "gpu_vm": BackendSpec("gpu_vm", "vm", provision_s=180.0, usd_per_hr=3.06,
                          gflops=7800.0, net_gbps=10.0),
}

BackendLike = Union[None, str, BackendSpec]


def resolve_backend(backend: BackendLike) -> Optional[BackendSpec]:
    """Resolve a backend name/spec to the spec the engine executes.

    ``None``, ``""``, and plain (non-spot) ``"serverless"`` resolve to
    ``None`` — the legacy serverless code path, kept byte-identical."""
    if backend is None or backend == "":
        return None
    if isinstance(backend, str):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} "
                             f"(known: {sorted(BACKENDS)})")
        backend = BACKENDS[backend]
    if backend.kind == "serverless" and not backend.spot:
        return None
    return backend


def spot_variant(base: BackendLike, price_trace: PriceTrace,
                 bid_usd_per_hr: float,
                 spot_policy: str = "fallback") -> BackendSpec:
    """A spot-tier copy of a VM backend priced by ``price_trace``."""
    spec = BACKENDS[base] if isinstance(base, str) else base
    if spec is None or spec.kind != "vm":
        raise ValueError("spot tier applies to vm backends")
    return dataclasses.replace(
        spec, name=spec.name + "_spot", spot=True, price_trace=price_trace,
        bid_usd_per_hr=bid_usd_per_hr, spot_policy=spot_policy)


# ---------------------------------------------------------------------------
# closed-form spot-run model (cadence study)
# ---------------------------------------------------------------------------


def simulate_spot_epoch(work_s: float, backend: BackendSpec, *,
                        cadence_s: Optional[float] = None,
                        ckpt_write_s: float = 2.0,
                        restore_s: float = 1.5,
                        n_workers: int = 1,
                        hazard_horizon_s: float = 1800.0) -> Dict[str, float]:
    """Deterministic trace-driven run of ``work_s`` seconds of lockstep
    work on a spot backend, checkpointing every ``cadence_s`` seconds
    (``None``: hazard-aware — the trace is treated as a price forecast;
    the base interval is the Young–Daly optimum for the forward hazard
    over ``hazard_horizon_s``, recomputed after every checkpoint, and
    progress-at-risk is flushed by a checkpoint timed to complete just
    before a forecast bid crossing).

    Preemption at each price up-crossing of the bid loses the work since
    the last completed checkpoint; the fleet then re-provisions and
    restores. ``spot_policy="wait"`` additionally sits out the spike
    unbilled until the price drops back below the bid;
    ``"fallback"`` resumes immediately on on-demand billing (no further
    preemptions). Billing runs from the end of each provisioning to the
    preemption/teardown, at the trace price (spot) or the flat
    on-demand rate (after fallback). Returns wall/cost/preemptions/
    checkpoint counts."""
    trace, bid = backend.price_trace, backend.bid_usd_per_hr
    if trace is None:
        raise ValueError("simulate_spot_epoch needs a spot backend")

    def _cadence(t: float) -> float:
        if cadence_s is not None:
            return cadence_s
        lam = trace.hazard_per_s(bid, t, hazard_horizon_s)
        return hazard_cadence_s(lam, ckpt_write_s)

    t = trace.next_drop_below(0.0, bid)    # can't provision above the bid
    if math.isinf(t):
        raise ValueError("price never at/below bid; spot run cannot start")
    done_s = 0.0                           # checkpointed progress
    usd = 0.0
    preemptions = checkpoints = 0
    on_demand = False
    t += backend.provision_s
    while done_s < work_s:
        kill_t = (math.inf if on_demand
                  else trace.next_crossing_above(t, bid))
        bill_t0 = t                        # billing arms after provisioning
        # run work-then-checkpoint stretches until finish or preemption
        while t < kill_t and done_s < work_s:
            span = min(_cadence(t), work_s - done_s)
            if cadence_s is None and not math.isinf(kill_t):
                # progress-at-risk flush: time the last checkpoint to
                # complete just before the forecast crossing
                span = min(span, kill_t - ckpt_write_s - t)
                if span <= 0.0:
                    t = kill_t             # nothing at risk fits; idle out
                    break
            fin = t + span
            if done_s + span >= work_s and fin <= kill_t:
                done_s = work_s            # final stretch: no trailing ckpt
                t = fin
            elif fin + ckpt_write_s <= kill_t:
                done_s += span             # checkpoint completes in time
                checkpoints += 1
                t = fin + ckpt_write_s
            else:
                t = kill_t                 # preempted mid-stretch/mid-ckpt:
                break                      # progress since last ckpt is lost
        preempted = done_s < work_s
        if preempted:
            preemptions += 1
        usd += n_workers * (
            (t - bill_t0) * backend.usd_per_s if on_demand
            else trace.integral_usd(bill_t0, t))
        if not preempted:
            break
        # restart from the last completed checkpoint
        if backend.spot_policy == "fallback":
            on_demand = True
            t = t + backend.provision_s + restore_s
        else:
            rec_t = trace.next_drop_below(t, bid)
            if math.isinf(rec_t):
                raise ValueError("price never recovers below bid")
            t = rec_t + backend.provision_s + restore_s
    return {"wall_s": t, "cost_usd": usd, "preemptions": float(preemptions),
            "checkpoints": float(checkpoints),
            "on_demand": 1.0 if on_demand else 0.0}
