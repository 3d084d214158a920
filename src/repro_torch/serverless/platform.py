"""Discrete-event serverless (FaaS) platform model.

The paper's economics run on AWS Lambda + S3 + Redis-on-ECS. A GPU host is
not pay-per-GB-second, so we keep the paper's *pricing and platform
semantics* (cold starts, 15-minute duration caps, memory-proportional
CPU/network, failures) in a deterministic simulator. The numerics of
training itself run as real PyTorch (small models) or through an analytic
workload model (paper-scale models); see ``repro_torch.serverless.worker``.

A copy of the JAX package's ``serverless/platform.py`` (numpy only): the
same seed gives the same draws, bit for bit.

Constants are calibrated to public AWS pricing (us-east-1, 2022):
  Lambda: $1.6667e-5 / GB-s, $2e-7 / request, 128MB..10240MB, 900s cap,
          1 vCPU per 1769MB, network scales with memory up to ~600 Mbps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serverless.backends import PriceTrace


LAMBDA_GB_SECOND = 1.6667e-5
LAMBDA_PER_REQUEST = 2e-7
LAMBDA_MAX_DURATION_S = 900.0
LAMBDA_MIN_MEMORY_MB = 128
LAMBDA_MAX_MEMORY_MB = 10_240
MB_PER_VCPU = 1769.0
PEAK_NET_GBPS = 0.075        # ~600 Mbit/s per function at full memory
PEAK_CPU_GFLOPS = 40.0       # effective GFLOP/s of one Lambda vCPU (f32)
CHECKPOINT_RESTORE_S = 1.5   # restore model + iterator state on restart
DATA_OBJECT_BYTES = 250e6    # paper: dataset split into <=250MB objects


def vcpus(memory_mb: float) -> float:
    return min(6.0, max(memory_mb / MB_PER_VCPU, 0.07))


def fn_gflops(memory_mb: float) -> float:
    """Effective compute of one function — scales with allocated memory."""
    return vcpus(memory_mb) * PEAK_CPU_GFLOPS


def fn_net_gbps(memory_mb: float) -> float:
    """Per-function network bandwidth (GB/s) — scales with memory, capped."""
    return PEAK_NET_GBPS * min(1.0, memory_mb / 10_240 * 4)


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One function slot of a (possibly heterogeneous) fleet. Compute and
    network derive from ``memory_mb`` (``fn_gflops`` / ``fn_net_gbps``);
    ``tier`` labels the capacity pool (e.g. "spot" slots can be targeted by
    a correlated-failure ``ShockModel``)."""
    memory_mb: float
    tier: str = "standard"


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Per-worker deployment of one job: a tuple of ``WorkerSpec``s.

    ``FleetSpec.homogeneous(n, mem)`` reproduces the classic
    ``(n_workers, memory_mb)`` deployment exactly; mixed fleets give each
    worker its own compute rate, network cap, and GB-second billing rate.
    """
    workers: Tuple[WorkerSpec, ...]

    def __post_init__(self):
        if not self.workers:
            raise ValueError("FleetSpec needs at least one worker")

    def __len__(self) -> int:
        return len(self.workers)

    @classmethod
    def homogeneous(cls, n: int, memory_mb: float,
                    tier: str = "standard") -> "FleetSpec":
        return cls(tuple(WorkerSpec(memory_mb, tier) for _ in range(n)))

    @classmethod
    def mixed(cls, groups: Sequence[Tuple[int, float, str]]) -> "FleetSpec":
        """``groups``: (count, memory_mb, tier) per tier, concatenated in
        order (worker ids are assigned group by group)."""
        specs: List[WorkerSpec] = []
        for count, mem, tier in groups:
            specs.extend(WorkerSpec(mem, tier) for _ in range(count))
        return cls(tuple(specs))

    @property
    def memories(self) -> Tuple[float, ...]:
        return tuple(w.memory_mb for w in self.workers)

    @property
    def total_memory_mb(self) -> float:
        return sum(self.memories)

    @property
    def is_homogeneous(self) -> bool:
        return len(set(self.memories)) == 1

    def gflops_harmonic(self) -> float:
        """Weighted-harmonic effective per-worker compute rate: with equal
        local batches the *mean* iteration compute time equals the time at
        this rate (exact in the identical-memory limit)."""
        return len(self) / sum(1.0 / fn_gflops(m) for m in self.memories)

    def gflops_total(self) -> float:
        """Aggregate fleet compute rate — the load-aware placement's
        denominator: with the global batch split in proportion to worker
        speed, every worker computes for ``flops * batch / total``."""
        return sum(fn_gflops(m) for m in self.memories)

    def min_net_gbps(self) -> float:
        """Sync bound for the analytic approximation: a barriered exchange
        completes no faster than the narrowest worker's pipe."""
        return min(fn_net_gbps(m) for m in self.memories)


def fleet_from_config(workers: int, memory_mb: float, small_frac: float = 0.0,
                      small_memory_ratio: float = 0.5) -> FleetSpec:
    """The Bayesian optimizer's searchable fleet composition: a fraction
    ``small_frac`` of the fleet runs at ``memory_mb * small_memory_ratio``
    (tier "small"), the rest at full memory (tier "standard")."""
    n_small = int(round(workers * small_frac))
    n_small = min(max(n_small, 0), workers)
    small_mb = max(memory_mb * small_memory_ratio, LAMBDA_MIN_MEMORY_MB)
    return FleetSpec.mixed([(workers - n_small, memory_mb, "standard"),
                            (n_small, small_mb, "small")]
                           if n_small else [(workers, memory_mb, "standard")])


@dataclasses.dataclass(frozen=True)
class ShockModel:
    """Correlated (spot-style) failure process: shared shocks arrive as a
    Poisson process with mean inter-arrival ``interval_s``; at each shock
    every in-flight worker of the targeted ``tier`` (None = all tiers) dies
    independently with probability ``kill_frac`` — so one shock can kill a
    random subset of the fleet at once, unlike the per-iteration
    independent ``failure_rate``.

    With a ``price_trace`` + ``bid_usd_per_hr``, arrivals switch from
    Poisson to *deterministic*: a shock fires at every up-crossing of the
    bid by the spot price (engine-relative time), modeling correlated
    spot-market preemptions. ``kill_frac`` / ``tier`` still select which
    workers each crossing kills (e.g. only the "spot" tier of a mixed
    fleet)."""
    interval_s: float
    kill_frac: float = 0.5
    tier: Optional[str] = None
    price_trace: Optional[PriceTrace] = None
    bid_usd_per_hr: float = 0.0

    def __post_init__(self):
        if self.interval_s <= 0:
            raise ValueError("shock interval_s must be positive")
        if not 0.0 <= self.kill_frac <= 1.0:
            raise ValueError("shock kill_frac must be in [0, 1]")
        if self.price_trace is not None and self.bid_usd_per_hr <= 0:
            raise ValueError("price-driven shocks need a positive bid")


@dataclasses.dataclass
class BillingLedger:
    gb_seconds: float = 0.0
    requests: int = 0
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per-task cost attribution: when several workflow tasks bill one
    # shared platform, ``job_usd`` breaks the one bill down by job label
    # (a bookkeeping view — never added into ``total_cost``)
    job_usd: Dict[str, float] = dataclasses.field(default_factory=dict)

    def attribute(self, job: str, dollars: float):
        self.job_usd[job] = self.job_usd.get(job, 0.0) + dollars

    def charge_fn(self, memory_mb: float, duration_s: float):
        self.gb_seconds += memory_mb / 1024.0 * duration_s
        self.requests += 1

    def charge_fleet(self, memory_mb: float, n_workers: int,
                     duration_s: float, invocations_per_worker: int = 1):
        """Bill a fleet the way Lambda does: every worker is its own
        invocation (n requests), and every duration-cap restart is a fresh
        request on top. ``duration_s`` is the per-worker billed duration."""
        self.gb_seconds += memory_mb / 1024.0 * duration_s * n_workers
        self.requests += n_workers * max(invocations_per_worker, 1)

    def charge(self, key: str, dollars: float):
        self.extra[key] = self.extra.get(key, 0.0) + dollars

    @property
    def lambda_cost(self) -> float:
        return (self.gb_seconds * LAMBDA_GB_SECOND
                + self.requests * LAMBDA_PER_REQUEST)

    @property
    def total_cost(self) -> float:
        return self.lambda_cost + sum(self.extra.values())


@dataclasses.dataclass
class InvocationRecord:
    worker_id: int
    start: float
    end: float = 0.0
    cold_start_s: float = 0.0
    failed: bool = False
    resumed: bool = False        # continuation of a duration-capped invocation


class ServerlessPlatform:
    """Deterministic FaaS simulator: invocations, cold starts, duration caps,
    failure injection, and GB-second billing."""

    def __init__(self, *, max_duration_s: float = LAMBDA_MAX_DURATION_S,
                 cold_start_base_s: float = 0.25,
                 cold_start_per_code_gb_s: float = 2.5,
                 failure_rate: float = 0.0, seed: int = 0):
        self.max_duration_s = max_duration_s
        self.cold_start_base_s = cold_start_base_s
        self.cold_start_per_code_gb_s = cold_start_per_code_gb_s
        self.failure_rate = failure_rate
        # deferred as in the JAX package, whose ``core`` package init
        # reaches back into this leaf module (a top-level import cycles)
        from repro_torch.core.rng import base_stream
        self.rng = base_stream(seed)
        self.ledger = BillingLedger()
        self.invocations: List[InvocationRecord] = []
        self.now = 0.0

    # -- invocation lifecycle ------------------------------------------------
    def cold_start(self, code_size_mb: float, framework_init_s: float) -> float:
        """Time from invoke to user code running: container + deps + framework
        (e.g. ~4 s for Resnet-18 on TF per the paper, Section 4.1)."""
        return (self.cold_start_base_s
                + self.cold_start_per_code_gb_s * code_size_mb / 1024.0
                + framework_init_s)

    def invoke(self, worker_id: int, code_size_mb: float,
               framework_init_s: float) -> InvocationRecord:
        rec = InvocationRecord(worker_id=worker_id, start=self.now,
                               cold_start_s=self.cold_start(
                                   code_size_mb, framework_init_s))
        self.invocations.append(rec)
        return rec

    def iteration_fails(self) -> bool:
        return bool(self.rng.random_sample() < self.failure_rate)

    def finish(self, rec: InvocationRecord, memory_mb: float,
               end: float) -> List[InvocationRecord]:
        """Bill an invocation, enforcing the duration cap: a run longer than
        ``max_duration_s`` is split into a chain of capped invocations
        (checkpoint/restart), each billed as its own request — a single
        Lambda invocation can never bill beyond the cap."""
        recs = [rec]
        duration = max(end - rec.start, 0.0)
        while duration > self.max_duration_s:
            rec.end = rec.start + self.max_duration_s
            self.ledger.charge_fn(memory_mb, self.max_duration_s)
            duration -= self.max_duration_s
            rec = InvocationRecord(worker_id=rec.worker_id, start=rec.end,
                                   cold_start_s=rec.cold_start_s, resumed=True)
            self.invocations.append(rec)
            recs.append(rec)
        rec.end = rec.start + duration
        self.ledger.charge_fn(memory_mb, duration)
        return recs

    # -- time ------------------------------------------------------------------
    def advance(self, dt: float):
        self.now += dt
