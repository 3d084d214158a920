"""Monetary cost + wall-time estimation (the S_B(C) / T_B(C) of Section 3.2).

Covers the serverless deployment (Lambda + S3 + Redis-on-ECS), the
profiling runs the Bayesian optimizer pays for, and the VM baselines the
paper compares against (IaaS and MLCD-style VM platforms).

A copy of the JAX package's ``core/cost_model.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.core.bayes_opt import Config
from repro_torch.serverless.backends import BackendLike, BackendSpec, resolve_backend
from repro_torch.serverless.platform import (  # noqa: F401  (re-exported names)
    CHECKPOINT_RESTORE_S, DATA_OBJECT_BYTES, LAMBDA_GB_SECOND,
    LAMBDA_MAX_DURATION_S, LAMBDA_PER_REQUEST, FleetSpec, fleet_from_config)
from repro_torch.serverless.stores import ObjectStore, ParamStore
from repro_torch.core.comm import CommLike
from repro_torch.serverless.worker import Workload, iteration_time


def _config_fleet(config: Config,
                  fleet: Optional[FleetSpec]) -> Optional[FleetSpec]:
    """Resolve the deployment's fleet: an explicit ``fleet`` wins; a config
    with a searched fleet composition (``small_frac > 0``) expands to its
    mixed fleet; a plain homogeneous config stays on the exact closed form
    (fleet=None)."""
    if fleet is not None:
        return fleet
    if getattr(config, "small_frac", 0.0) > 0.0:
        return fleet_from_config(config.workers, config.memory_mb,
                                 config.small_frac)
    return None


def _config_backend(config: Config,
                    backend: BackendLike) -> Optional[BackendSpec]:
    """Resolve the deployment's backend: an explicit ``backend`` wins; a
    config with a searched backend (``config.backend``) resolves through
    the registry; plain serverless stays on the exact legacy closed form
    (None)."""
    if backend is not None:
        return resolve_backend(backend)
    return resolve_backend(getattr(config, "backend", ""))


@dataclasses.dataclass
class EpochEstimate:
    wall_s: float
    lambda_usd: float
    store_usd: float
    iters: int
    it_breakdown: Dict[str, float]
    restarts_per_worker: int
    global_batch: int = 0        # samples per iteration (throughput basis)
    backend_usd: float = 0.0     # per-second VM/GPU compute dollars

    @property
    def cost_usd(self) -> float:
        return self.lambda_usd + self.store_usd + self.backend_usd

    @property
    def throughput(self) -> float:  # samples / s
        return 0.0 if self.wall_s == 0 else (
            self.iters * self.global_batch / self.wall_s)


def epoch_estimate(w: Workload, scheme: CommLike, config: Config,
                   global_batch: int, param_store: ParamStore,
                   object_store: ObjectStore, *,
                   framework_init_s: float = 4.0,
                   cold_start_s: float = 2.0,
                   max_duration_s: float = LAMBDA_MAX_DURATION_S,
                   samples: Optional[int] = None,
                   fleet: Optional[FleetSpec] = None,
                   backend: BackendLike = None) -> EpochEstimate:
    """Analytic time+cost of one epoch under deployment ``config``.

    A heterogeneous ``fleet`` (explicit, or implied by
    ``config.small_frac``) switches iteration costing to the mixed-memory
    approximation (weighted-harmonic compute, min-bandwidth sync; see
    ``iteration_time``) and bills GB-seconds at each worker's own memory —
    cheap enough for the Bayesian optimizer to probe fleet compositions.

    A VM-kind ``backend`` (explicit, or implied by ``config.backend``)
    swaps the execution semantics: provisioning delay replaces the cold
    start, there is no duration cap (so no cap restarts), and billing is
    per-second per worker from the end of provisioning (no GB-second or
    per-request fee); spot tiers bill at the price trace's time-average
    rate. Store billing is unchanged — VM workers synchronize through
    the same stores."""
    spec = _config_backend(config, backend)
    fleet = _config_fleet(config, fleet)
    n, mem = config.workers, config.memory_mb
    if fleet is not None:
        # an explicit fleet wins over the config shape: n (and total_mem
        # below) come from it; iteration_time resolves per-worker memory
        # from the fleet itself
        n = len(fleet)
    samples = samples or w.dataset_samples
    iters = max(math.ceil(samples / global_batch), 1)
    it = iteration_time(w, scheme, n, mem, global_batch, param_store,
                        object_store, fleet=fleet, backend=spec)

    # duration-cap restarts (Section 4.1): amortize init across a full
    # window. The per-epoch data fetch runs inside the *first*
    # invocation's usable window (the engine arms the cap before the
    # fetch), so it counts against the first window's budget — a
    # compute load that alone fits one window can still restart once
    # the fetch is folded in. Uncapped VM backends never restart.
    if spec is None:
        init_s = cold_start_s + framework_init_s
        usable = max_duration_s - init_s - CHECKPOINT_RESTORE_S
    else:
        init_s = spec.provision_s + framework_init_s
        usable = math.inf
    epoch_compute_s = iters * it["total"]

    # per-epoch data fetch from the object store (data iterator, Section 4.2)
    shard_bytes = w.sample_bytes * samples / n
    data_fetch_s = object_store.get_time(shard_bytes, concurrent=n)
    n_objects = max(math.ceil(w.sample_bytes * samples / DATA_OBJECT_BYTES), 1)

    invocations_per_worker = max(
        math.ceil((epoch_compute_s + data_fetch_s) / usable), 1)
    restart_overhead = (invocations_per_worker - 1) * (init_s + CHECKPOINT_RESTORE_S)

    wall = epoch_compute_s + restart_overhead + init_s + data_fetch_s

    total_mem = fleet.total_memory_mb if fleet is not None else n * mem
    if spec is None:
        lambda_usd = (total_mem / 1024.0 * wall * LAMBDA_GB_SECOND
                      + n * invocations_per_worker * LAMBDA_PER_REQUEST)
        backend_usd = 0.0
    else:
        # per-second billing arms when provisioning+init completes (the
        # engine's billing anchor), so the billed window is wall - init_s
        lambda_usd = 0.0
        backend_usd = n * (wall - init_s) * spec.expected_usd_per_s
    # param store billed only while synchronization is actually holding
    # it (Section 4.3): the plan's per-phase store-busy time — re-upload
    # fan-in levels included, decompress CPU excluded — so billing stays
    # in parity with the event engine's keep-alive window for every
    # strategy
    sync_s = iters * it["store_busy"]
    store_hourly = (param_store.vcpus * 0.04048
                    + param_store.memory_gb * 0.004445)
    store_usd = sync_s / 3600.0 * store_hourly
    s3_usd = (n_objects * 0.0004 / 1000.0) * n  # GETs per epoch
    return EpochEstimate(wall_s=wall, lambda_usd=lambda_usd,
                         store_usd=store_usd + s3_usd, iters=iters,
                         it_breakdown=it,
                         restarts_per_worker=invocations_per_worker - 1,
                         global_batch=global_batch,
                         backend_usd=backend_usd)


def profile_cost(w: Workload, scheme: CommLike, config: Config,
                 global_batch: int,
                 param_store: ParamStore, object_store: ObjectStore,
                 profile_iters: int = 3, *, framework_init_s: float = 4.0,
                 cold_start_s: float = 2.0,
                 fleet: Optional[FleetSpec] = None,
                 backend: BackendLike = None):
    """Time+cost of one Bayesian-optimizer profiling probe (k iterations).

    The deployment an explicit ``fleet=`` describes *wins* over the
    config's ``(workers, memory_mb)``: n, per-iteration times, and the
    billed memory all resolve from the fleet, so a probe of a fleet
    whose shape differs from the config never mixes the two. A VM-kind
    ``backend`` prices the probe at its per-second rate (provisioning
    replaces the cold start, no request fee)."""
    spec = _config_backend(config, backend)
    fleet = _config_fleet(config, fleet)
    n = len(fleet) if fleet is not None else config.workers
    mem = (fleet.memories[0] if fleet is not None and fleet.is_homogeneous
           else config.memory_mb)
    it = iteration_time(w, scheme, n, mem, global_batch, param_store,
                        object_store, fleet=fleet, backend=spec)
    total_mem = (fleet.total_memory_mb if fleet is not None
                 else n * config.memory_mb)
    if spec is None:
        wall = cold_start_s + framework_init_s + profile_iters * it["total"]
        usd = (total_mem / 1024.0 * wall * LAMBDA_GB_SECOND
               + n * LAMBDA_PER_REQUEST)
    else:
        wall = spec.provision_s + framework_init_s + profile_iters * it["total"]
        usd = n * profile_iters * it["total"] * spec.expected_usd_per_s
    return wall, usd, it


# ---------------------------------------------------------------------------
# VM baselines (IaaS / MLCD) for Figs. 9-11
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VmType:
    name: str
    vcpus: int
    usd_hour: float
    gflops: float
    net_gbps: float


VM_TYPES = {
    "c5.2xlarge": VmType("c5.2xlarge", 8, 0.34, 8 * 45.0, 1.25),
    "c5.4xlarge": VmType("c5.4xlarge", 16, 0.68, 16 * 45.0, 1.25),
    "c5.9xlarge": VmType("c5.9xlarge", 36, 1.53, 36 * 45.0, 1.5),
}


def vm_epoch_estimate(w: Workload, vm: VmType, n_vms: int, global_batch: int,
                      samples: Optional[int] = None):
    """Ring-allreduce data-parallel training on VMs (the IaaS baseline)."""
    samples = samples or w.dataset_samples
    iters = max(math.ceil(samples / global_batch), 1)
    local = max(global_batch // n_vms, 1)
    comp = w.flops_per_sample * local / (vm.gflops * 1e9)
    # ring allreduce: 2*(n-1)/n * G bytes over the NIC
    comm = 2 * (n_vms - 1) / max(n_vms, 1) * w.grad_bytes / (vm.net_gbps / 8 * 1e9)
    wall = iters * (comp + comm)
    usd = n_vms * vm.usd_hour * wall / 3600.0
    return wall, usd
