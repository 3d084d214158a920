"""SMLT task scheduler (paper Sections 3.1 and 4.1).

Maintains the *overarching view* of the training workflow across stateless
function invocations: monitors per-iteration training dynamics, detects
configuration changes (batch size for dynamic batching, model size for NAS),
re-runs the Bayesian optimizer when they change, redeploys workers at the
new <n_workers, memory> configuration, enforces the function duration cap
with checkpoint/restart, and restarts failed workers.

Runs are *resumable*: ``run(max_epochs=...)`` executes a bounded slice and
returns a ``RunResult`` whose ``.state`` continues the same run when passed
back as ``resume=`` — totals, trace, and the adaptation RNG stream carry
over, so a sliced run is equivalent to one uninterrupted call. The epoch
loop itself is a generator (``drive``) that yields an ``EngineRequest``
for every event-engine execution it needs: the default ``run`` wrapper
builds and runs each engine standalone, while the workflow orchestrator
(``repro_torch.workflow``) builds them into a *shared* ``ContentionDomain`` at
the task's workflow-clock offset, co-scheduling many TaskScheduler jobs on
one simulated fleet.

A copy of the JAX package's ``core/scheduler.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, FrozenSet, List, Optional, Tuple


from repro_torch.core.bayes_opt import BayesianOptimizer, Config, ConfigSpace
from repro_torch.core.comm import CommSpec, parse_scheme
from repro_torch.core.constraints import (Goal, compression_inflation,
                                    preemption_inflation,
                                    staleness_inflation)
from repro_torch.core.cost_model import epoch_estimate, profile_cost
from repro_torch.core.monitor import ThroughputMonitor
from repro_torch.core.probe_cache import DEFAULT_CACHE, ProbeCache
from repro_torch.core.rng import base_stream
from repro_torch.serverless.backends import resolve_backend
from repro_torch.serverless.platform import ServerlessPlatform, fleet_from_config
from repro_torch.serverless.stores import ObjectStore, ParamStore
from repro_torch.serverless.worker import Workload


@dataclasses.dataclass
class EpochPlan:
    """One epoch of the (possibly dynamic) workflow."""
    batch_size: int
    workload: Workload                 # may differ per epoch (NAS)
    samples: Optional[int] = None      # online learning: samples that arrived


@dataclasses.dataclass
class TraceEvent:
    t: float
    epoch: int
    kind: str                          # one of KINDS (validated below)
    throughput: float = 0.0            # samples / s
    workers: int = 0
    memory_mb: int = 0
    batch_size: int = 0
    model_params: int = 0
    cost_cum: float = 0.0
    restarts: int = 0                  # duration-cap restarts, per worker
    failures: int = 0

    # every kind the scheduler emits; a new kind must be registered here
    # before it can appear in a trace, so typos fail loudly instead of
    # silently slipping past `events if e.kind == ...` filters
    KINDS: ClassVar[FrozenSet[str]] = frozenset(
        {"epoch", "reoptimize", "reoptimize_mid", "migrate"})

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown TraceEvent kind: {self.kind!r} "
                             "(register it in TraceEvent.KINDS)")


@dataclasses.dataclass
class SchedulerState:
    """Resumable cursor of a (possibly partial) ``TaskScheduler.run``.

    ``run(max_epochs=k)`` returns after k epoch plans with ``done=False``;
    passing the state back via ``resume=`` continues where it left off.
    ``stop_reason`` records why a finished run ended: "completed" (all
    plans executed), "deadline", or "budget"."""
    next_epoch: int = 0
    config: Optional[Config] = None
    last_sig: Optional[Tuple] = None
    t: float = 0.0
    cost: float = 0.0
    t_prof: float = 0.0
    usd_prof: float = 0.0
    epochs_done: int = 0
    events: List[TraceEvent] = dataclasses.field(default_factory=list)
    history: List[Config] = dataclasses.field(default_factory=list)
    rng_state: Optional[Tuple] = None
    done: bool = False
    stop_reason: str = ""              # "" | "completed" | "deadline" | "budget"
    # observed actual/forecast ratios (event path): the stop gates forecast
    # with epoch_estimate, which knows nothing of cross-job contention on a
    # shared domain — each completed epoch teaches the gate how much slower
    # and dearer this task actually runs than its isolated estimate
    cost_infl: float = 1.0
    time_infl: float = 1.0


@dataclasses.dataclass
class RunResult:
    events: List[TraceEvent]
    wall_s: float
    cost_usd: float
    profile_s: float
    profile_usd: float
    epochs_done: int
    config_history: List[Config]
    state: Optional[SchedulerState] = None

    @property
    def total_cost(self):
        return self.cost_usd + self.profile_usd

    @property
    def stop_reason(self) -> str:
        return self.state.stop_reason if self.state is not None else ""


@dataclasses.dataclass
class EngineRequest:
    """One event-engine execution the epoch loop needs.

    Yielded by ``TaskScheduler.drive``; the caller builds the engine —
    optionally into a shared ``ContentionDomain`` via
    ``build(domain=..., start_at=..., on_complete=...)`` — and sends the
    ``EngineResult`` back into the generator. ``at_t`` is the task-local
    clock (profiling + prior epochs) when the chunk starts, i.e. the
    offset at which a workflow orchestrator should admit the engine."""
    at_t: float
    build: Callable[..., object]


class TaskScheduler:
    def __init__(self, platform: ServerlessPlatform,
                 object_store: ObjectStore, param_store: ParamStore, *,
                 space: Optional[ConfigSpace] = None, scheme: str = "hier",
                 profile_iters: int = 3, framework_init_s: float = 4.0,
                 cold_start_s: float = 2.0, seed: int = 0,
                 probe_cap_s: float = 180.0, bo_max_iters: int = 12,
                 engine: str = "analytic",
                 engine_opts: Optional[Dict] = None,
                 mid_epoch_adapt: bool = True,
                 probe_cache: Optional[ProbeCache] = DEFAULT_CACHE,
                 job: str = ""):
        self.platform = platform
        self.object_store = object_store
        self.param_store = param_store
        self.space = space or ConfigSpace()
        self.scheme = scheme
        self.profile_iters = profile_iters
        self.framework_init_s = framework_init_s
        self.cold_start_s = cold_start_s
        self.seed = seed
        # probes longer than this are aborted and recorded as censored —
        # the resource manager never lets a bad config burn real money
        self.probe_cap_s = probe_cap_s
        self.bo_max_iters = bo_max_iters
        # "analytic": closed-form epoch_estimate (fast path; BO probes
        # always use it). "event": epochs execute on the discrete-event
        # engine (stragglers, failures, sync modes via ``engine_opts``),
        # and per-iteration completions feed a ThroughputMonitor that can
        # abort + re-optimize *mid-epoch* when throughput drifts.
        if engine not in ("analytic", "event"):
            raise ValueError(engine)
        self.engine = engine
        self.engine_opts = dict(engine_opts or {})
        self.mid_epoch_adapt = mid_epoch_adapt
        # memo table for the analytic probes (epoch_estimate/profile_cost):
        # shared process-wide by default so every scheduler reuses every
        # other's probes; pass None to recompute every closed form
        self.probe_cache = probe_cache
        # ledger attribution label: several workflow tasks billing one
        # shared platform stay separable in ``ledger.job_usd``
        self.job = job

    def _space_for(self, w: Workload) -> ConfigSpace:
        """Resource-manager floor: the function must hold model + grads +
        framework (Section 4.1) — prunes configs that could never run.
        The fleet-composition and comm-plan search dimensions carry over
        from the scheduler's space."""
        model_mb = int(3 * 4 * w.param_count / 1e6) + 512
        lo = min(max(self.space.min_memory, model_mb),
                 self.space.max_memory - 1)
        return dataclasses.replace(self.space, min_memory=lo)

    def _comm_for(self, config: Config):
        """The communication schedule a config deploys: the scheduler's
        default scheme unless the optimizer searched the comm dimensions
        (``Config.comm``/``compress_ratio``/``branching``/
        ``pipeline_depth``)."""
        if (not config.comm and config.compress_ratio >= 1.0
                and config.branching <= 0 and config.pipeline_depth <= 1):
            return self.scheme
        base = (parse_scheme(self.scheme) if not config.comm
                else CommSpec(config.comm))
        return dataclasses.replace(base, ratio=config.compress_ratio,
                                   branching=(config.branching
                                              if base.strategy == "hier"
                                              else 0),
                                   pipeline_depth=max(config.pipeline_depth,
                                                      1))

    def _epoch_estimate(self, *args, **kwargs):
        if self.probe_cache is not None:
            return self.probe_cache.epoch_estimate(*args, **kwargs)
        return epoch_estimate(*args, **kwargs)

    def _profile_cost(self, *args, **kwargs):
        if self.probe_cache is not None:
            return self.probe_cache.profile_cost(*args, **kwargs)
        return profile_cost(*args, **kwargs)

    # -- Bayesian re-optimization (triggered on training-dynamics change) ----
    def optimize(self, w: Workload, batch: int, goal: Goal,
                 epochs_remaining: int, samples: Optional[int],
                 warm_start: Optional[Config] = None):
        """``warm_start`` (beyond-paper): seed the GP with the previous
        deployment's config — good configs correlate across similar
        workloads, so a warm re-optimization needs ~half the probes."""
        limit = None
        if goal.kind == "min_cost_deadline":
            limit = goal.deadline_s
        elif goal.kind == "min_time_budget":
            limit = goal.budget_usd
        elif goal.kind == "deadline_budget":
            limit = 1.0                # normalized max(time, cost) constraint
        space = self._space_for(w)
        max_iters = self.bo_max_iters
        if warm_start is not None:
            max_iters = max(self.bo_max_iters // 2, 4)
        bo = BayesianOptimizer(space, constraint_limit=limit,
                               seed=self.seed, max_iters=max_iters)
        seeds = []
        if warm_start is not None:
            # keep the fleet-composition dimension: the warm-start probe
            # must profile the deployment that was actually running
            seeds = [Config(min(max(warm_start.workers, space.min_workers),
                                space.max_workers),
                            min(max(warm_start.memory_mb, space.min_memory),
                                space.max_memory),
                            warm_start.small_frac, warm_start.comm,
                            warm_start.compress_ratio, warm_start.branching,
                            warm_start.pipeline_depth, warm_start.backend)]
        t_prof = usd_prof = 0.0
        while not bo.done():
            c = seeds.pop(0) if seeds else bo.suggest()
            comm = self._comm_for(c)
            pt, pu, _ = self._profile_cost(
                w, comm, c, batch, self.param_store, self.object_store,
                self.profile_iters, framework_init_s=self.framework_init_s,
                cold_start_s=self.cold_start_s,
                backend=self.engine_opts.get("backend"))
            # the probe cap targets runaway *compute*, not the known fixed
            # provisioning delay a VM-kind candidate always pays
            cap = self.probe_cap_s
            spec = resolve_backend(self.engine_opts.get("backend")
                                   or c.backend)
            if spec is not None:
                cap += spec.provision_s
            if pt > cap:
                # censored probe: abort at the cap, record a pessimistic
                # objective so the GP steers away without full payment
                frac = cap / pt
                t_prof += cap
                usd_prof += pu * frac
                worst = max((o.objective for o in bo.obs), default=1.0)
                bo.observe(c, worst * 10.0,
                           None if limit is None else limit * 10.0)
                continue
            t_prof += pt
            usd_prof += pu
            est = self._epoch_estimate(
                w, comm, c, batch, self.param_store, self.object_store,
                framework_init_s=self.framework_init_s,
                cold_start_s=self.cold_start_s, samples=samples,
                backend=self.engine_opts.get("backend"))
            total_t = est.wall_s * epochs_remaining
            total_c = est.cost_usd * epochs_remaining
            # convergence-aware objective: a relaxed sync mode buys
            # wall-clock per epoch, a top-k ratio buys wire bytes — both
            # pay iterations-to-converge, so judge the candidate on
            # inflated time and dollars
            infl = staleness_inflation(
                self.engine_opts.get("sync_mode", "bsp"),
                self.engine_opts.get("staleness", 0), c.workers)
            infl *= compression_inflation(c.compress_ratio)
            # a spot deployment (engine_opts backend spec, or the
            # candidate's own) pays expected preemption overhead at the
            # hazard-aware Young–Daly cadence
            be = resolve_backend(self.engine_opts.get("backend")
                                 or c.backend)
            if be is not None and be.spot:
                infl *= preemption_inflation(
                    be.price_trace.hazard_per_s(be.bid_usd_per_hr))
            obj, cons, _ = goal.objective_and_constraint(total_t, total_c,
                                                         inflation=infl)
            bo.observe(c, obj, cons)
        if usd_prof > 0.0:
            # profiling probes are real invocations: they belong on the
            # shared bill, attributed to this job
            self.platform.ledger.charge("profile", usd_prof)
            self.platform.ledger.attribute(self.job, usd_prof)
        # probes run real training iterations (the paper profiles live
        # throughput) — those samples count toward the epoch
        useful = sum(1 for o in bo.obs) * self.profile_iters * batch
        return bo.best().config, t_prof, usd_prof, useful

    # -- cross-backend migration ---------------------------------------------
    def _migrate(self, old: Optional[Config], new: Config,
                 w: Workload) -> float:
        """Migration protocol at re-optimization: when the optimizer moves
        the job to a different backend, the model + optimizer state
        (params + Adam m,v) checkpoints out through the ObjectStore under
        the old deployment and restores under the new one. Returns the
        wall overhead of the two transfers; the new backend's
        provisioning delay is paid by the next deployment's own init.
        No-op when the backend is unchanged."""
        if old is None or old.backend == new.backend:
            return 0.0
        ckpt_bytes = 12.0 * w.param_count
        key = f"migrate/{self.job or 'job'}"
        self.object_store.put(key, {"params": w.param_count},
                              nbytes=ckpt_bytes)
        dt = self.object_store.put_time(ckpt_bytes)
        self.object_store.get(key, nbytes=ckpt_bytes)
        dt += self.object_store.get_time(ckpt_bytes)
        return dt

    # -- event-engine epoch execution ----------------------------------------
    def _run_epoch_event(self, plan: EpochPlan, goal: Goal, config: Config,
                         samples_left: int, epoch_i: int, n_plans: int,
                         adaptive: bool, events: List[TraceEvent],
                         t_base: float, cost_base: float):
        """Execute one epoch on the discrete-event engine, in chunks: when
        the per-iteration ThroughputMonitor detects a sustained drift, the
        engine checkpoints and stops, we re-optimize *mid-epoch*, and the
        remaining samples run under the new deployment.

        This is a generator: every engine execution is a yielded
        ``EngineRequest`` whose ``EngineResult`` is sent back in, so a
        workflow orchestrator can run the chunk on a shared domain."""
        # deferred as in the JAX package: events consumes the CommPlan IR
        # from ``core``, whose package init there imports this module
        from repro_torch.serverless.events import EventEngine
        wall = cost = 0.0
        restarts = failures = 0
        t_prof = usd_prof = 0.0
        configs: List[Config] = []
        remaining = samples_left
        attempt = 0
        iters_epoch = 0
        while remaining > 0:
            monitor = ThroughputMonitor()

            def on_it(g, t_now, dt, _m=monitor, _b=plan.batch_size):
                if dt <= 0 or not (adaptive and self.mid_epoch_adapt):
                    return False
                return _m.observe(_b / dt)

            opts = {"failure_rate": self.platform.failure_rate,
                    **self.engine_opts}
            # a slowdown injection is an epoch-level regression: keep its
            # onset fixed in epoch-iteration space across restarted chunks
            if opts.get("slowdown_at_iter") is not None:
                opts["slowdown_at_iter"] = max(
                    opts["slowdown_at_iter"] - iters_epoch, 0)
            # a searched fleet composition deploys as its mixed fleet
            # (an explicit engine_opts fleet overrides the config's)
            if config.small_frac > 0.0 and "fleet" not in opts:
                opts["fleet"] = fleet_from_config(
                    config.workers, config.memory_mb, config.small_frac)
            # a searched backend deploys on its engine semantics (an
            # explicit engine_opts backend — e.g. a spot variant — wins)
            if config.backend and "backend" not in opts:
                opts["backend"] = config.backend
            args = (plan.workload, self._comm_for(config), config.workers,
                    config.memory_mb, plan.batch_size, self.param_store,
                    self.object_store)
            kwargs = dict(platform=self.platform,
                          framework_init_s=self.framework_init_s,
                          cold_start_s=self.cold_start_s,
                          max_duration_s=self.platform.max_duration_s,
                          samples=remaining,
                          seed=self.seed + 7919 * epoch_i + attempt,
                          on_iteration=on_it, **opts)
            # perf default: engine epochs skip trace accumulation unless
            # the caller's engine_opts asked for it (either spelling)
            if "trace_enabled" not in kwargs:
                kwargs.setdefault("record_trace", False)
            r = yield EngineRequest(
                at_t=t_base + wall + t_prof,
                build=lambda args=args, kwargs=kwargs, **extra: EventEngine(
                    *args, **{**kwargs, **extra}))
            wall += r.wall_s
            cost += r.cost_usd
            # the engine's lambda dollars reached the shared ledger through
            # platform.finish; the store-side dollars did not — put them on
            # the bill too, and attribute the whole chunk to this job
            self.platform.ledger.charge("store", r.store_usd)
            self.platform.ledger.attribute(self.job, r.cost_usd)
            # EngineResult.restarts is fleet-wide; TraceEvent.restarts is
            # per worker (matching the analytic path's restarts_per_worker)
            restarts += round(r.restarts / config.workers)
            failures += r.failures
            remaining -= max(r.samples_done, plan.batch_size)
            iters_epoch += r.iters_done
            attempt += 1
            if r.stopped_early and remaining > 0 and adaptive:
                prev = config
                config, pt, pu, profiled = self.optimize(
                    plan.workload, plan.batch_size, goal,
                    epochs_remaining=n_plans - epoch_i, samples=remaining,
                    warm_start=config)
                t_prof += pt
                usd_prof += pu
                remaining = max(remaining - profiled, 0)
                configs.append(config)
                events.append(TraceEvent(
                    t_base + wall + t_prof, epoch_i, "reoptimize_mid",
                    workers=config.workers, memory_mb=config.memory_mb,
                    batch_size=plan.batch_size,
                    model_params=plan.workload.param_count,
                    cost_cum=cost_base + cost + usd_prof))
                mig = self._migrate(prev, config, plan.workload)
                if mig > 0.0:
                    wall += mig
                    events.append(TraceEvent(
                        t_base + wall + t_prof, epoch_i, "migrate",
                        workers=config.workers, memory_mb=config.memory_mb,
                        batch_size=plan.batch_size,
                        model_params=plan.workload.param_count,
                        cost_cum=cost_base + cost + usd_prof))
            elif not r.stopped_early:
                break
        meta = {"t_prof": t_prof, "usd_prof": usd_prof, "configs": configs}
        return wall, cost, restarts, failures, config, meta

    # -- main loop ------------------------------------------------------------
    def run(self, plans: List[EpochPlan], goal: Goal, *, adaptive: bool = True,
            fixed_config: Optional[Config] = None,
            stop_at_deadline: bool = False,
            stop_at_budget: bool = False,
            max_epochs: Optional[int] = None,
            resume: Optional[SchedulerState] = None,
            warm_start: Optional[Config] = None) -> RunResult:
        """Execute the epoch plans under ``goal``.

        ``stop_at_deadline`` / ``stop_at_budget`` break before an epoch
        that would push wall time past ``goal.deadline_s`` / total cost
        past ``goal.budget_usd``. ``max_epochs`` bounds this call to a
        slice; pass the returned ``RunResult.state`` back as ``resume=``
        to continue. ``warm_start`` seeds the first optimization with a
        config from another run (cross-task reuse)."""
        gen = self.drive(plans, goal, adaptive=adaptive,
                         fixed_config=fixed_config,
                         stop_at_deadline=stop_at_deadline,
                         stop_at_budget=stop_at_budget,
                         max_epochs=max_epochs, resume=resume,
                         warm_start=warm_start)
        try:
            req = next(gen)
            while True:
                req = gen.send(req.build().run())
        except StopIteration as stop:
            return stop.value

    def drive(self, plans: List[EpochPlan], goal: Goal, *,
              adaptive: bool = True, fixed_config: Optional[Config] = None,
              stop_at_deadline: bool = False, stop_at_budget: bool = False,
              max_epochs: Optional[int] = None,
              resume: Optional[SchedulerState] = None,
              warm_start: Optional[Config] = None):
        """Generator form of ``run``: yields an ``EngineRequest`` for
        every event-engine execution, expects its ``EngineResult`` sent
        back, and returns the ``RunResult`` via ``StopIteration.value``.
        The workflow orchestrator drives many of these concurrently on
        one shared ``ContentionDomain``."""
        st = resume if resume is not None else SchedulerState(
            config=fixed_config)
        if st.done:
            raise ValueError("cannot resume a finished run "
                             f"(stop_reason={st.stop_reason!r})")
        events, history = st.events, st.history
        config = st.config
        last_sig = st.last_sig
        t, cost = st.t, st.cost
        t_prof, usd_prof = st.t_prof, st.usd_prof
        epochs_done = st.epochs_done
        rng = base_stream(self.seed)
        if st.rng_state is not None:
            rng.set_state(st.rng_state)
        executed = 0
        i = st.next_epoch
        paused = False

        while i < len(plans):
            if max_epochs is not None and executed >= max_epochs:
                paused = True
                break
            plan = plans[i]
            sig = (plan.batch_size, plan.workload.param_count,
                   plan.workload.flops_per_sample)
            profiled_samples = 0
            if config is None or (adaptive and sig != last_sig):
                prev = config
                config, pt, pu, profiled_samples = self.optimize(
                    plan.workload, plan.batch_size, goal,
                    epochs_remaining=len(plans) - i, samples=plan.samples,
                    warm_start=config if config is not None else warm_start)
                t += pt
                cost += pu
                t_prof += pt
                usd_prof += pu
                events.append(TraceEvent(t, i, "reoptimize",
                                         workers=config.workers,
                                         memory_mb=config.memory_mb,
                                         batch_size=plan.batch_size,
                                         model_params=plan.workload.param_count,
                                         cost_cum=cost))
                mig = self._migrate(prev, config, plan.workload)
                if mig > 0.0:
                    # the job changes execution target: checkpoint out,
                    # restore under the new backend, resume
                    t += mig
                    events.append(TraceEvent(
                        t, i, "migrate", workers=config.workers,
                        memory_mb=config.memory_mb,
                        batch_size=plan.batch_size,
                        model_params=plan.workload.param_count,
                        cost_cum=cost))
            last_sig = sig

            samples_plan = plan.samples or plan.workload.dataset_samples
            samples_left = max(samples_plan - profiled_samples,
                               plan.batch_size)

            # forecast gate: never *start* an epoch whose estimate busts
            # the budget (both paths) or — on the event path, where the
            # epoch's ledger/store/shared-clock side effects are
            # irreversible once it runs — the deadline
            est_pre = None
            if ((stop_at_budget and goal.budget_usd is not None)
                    or (self.engine == "event" and stop_at_deadline
                        and goal.deadline_s is not None)):
                est_pre = self._epoch_estimate(
                    plan.workload, self._comm_for(config), config,
                    plan.batch_size, self.param_store, self.object_store,
                    framework_init_s=self.framework_init_s,
                    cold_start_s=self.cold_start_s, samples=samples_left,
                    backend=self.engine_opts.get("backend"))
            if (stop_at_budget and goal.budget_usd is not None
                    and cost + est_pre.cost_usd * st.cost_infl
                    > goal.budget_usd):
                st.stop_reason = "budget"
                break
            if (self.engine == "event" and stop_at_deadline
                    and goal.deadline_s is not None
                    and t + est_pre.wall_s * st.time_infl > goal.deadline_s):
                st.stop_reason = "deadline"
                break

            history.append(config)

            if self.engine == "event":
                # the epoch actually executed (stores + ledger already
                # carry its side effects); a later deadline break only
                # drops it from the result totals
                wall, epoch_cost, restarts, failures, config, meta = \
                    yield from self._run_epoch_event(
                        plan, goal, config, samples_left, i, len(plans),
                        adaptive, events, t, cost)
                t_prof += meta["t_prof"]
                usd_prof += meta["usd_prof"]
                t += meta["t_prof"]
                cost += meta["usd_prof"]
                history.extend(meta["configs"])
                commit = None
                if est_pre is not None:
                    # calibrate the stop gates on what this epoch really
                    # cost vs its isolated forecast (shared-domain
                    # contention, stragglers, failures)
                    if est_pre.cost_usd > 0:
                        st.cost_infl = max(1.0, epoch_cost
                                           / est_pre.cost_usd)
                    if est_pre.wall_s > 0:
                        st.time_infl = max(1.0, wall / est_pre.wall_s)
            else:
                est = est_pre if est_pre is not None else self._epoch_estimate(
                    plan.workload, self._comm_for(config), config,
                    plan.batch_size, self.param_store, self.object_store,
                    framework_init_s=self.framework_init_s,
                    cold_start_s=self.cold_start_s, samples=samples_left,
                    backend=self.engine_opts.get("backend"))
                # fault injection: failed iterations are redone (Section 4.1)
                failures = int(rng.binomial(est.iters,
                                            self.platform.failure_rate))
                redo_s = failures * est.it_breakdown["total"]
                wall = est.wall_s + redo_s
                epoch_cost = est.cost_usd * (wall / est.wall_s)
                restarts = est.restarts_per_worker

                def commit(est=est, wall=wall, config=config,
                           epoch_cost=epoch_cost):
                    # per-phase store-busy time from the plan (re-upload
                    # fan-in included, decompress CPU excluded) — the
                    # same basis epoch_estimate bills store_usd on
                    self.param_store.keep_alive(
                        est.iters * est.it_breakdown["store_busy"])
                    scale = wall / est.wall_s
                    spec = resolve_backend(
                        self.engine_opts.get("backend") or config.backend)
                    if spec is None:
                        # Lambda semantics: every worker is a request, and
                        # every duration-cap restart re-invokes the fleet
                        self.platform.ledger.charge_fleet(
                            config.memory_mb, config.workers, wall,
                            invocations_per_worker=est.restarts_per_worker
                            + 1)
                    else:
                        # per-second VM billing: no GB-seconds, no requests
                        self.platform.ledger.charge(
                            f"backend:{spec.name}",
                            est.backend_usd * scale)
                    self.platform.ledger.charge("store",
                                                est.store_usd * scale)
                    self.platform.ledger.attribute(self.job, epoch_cost)

            if (stop_at_deadline and goal.deadline_s is not None
                    and t + wall > goal.deadline_s):
                st.stop_reason = "deadline"
                if commit is None:
                    # event-path epochs bill as they run: the overshooting
                    # epoch's dollars are already on the shared ledger, so
                    # they stay in this run's cost even though its samples
                    # are discarded from the result — a budget layer above
                    # (the workflow allocator) must see money that is gone
                    cost += epoch_cost
                break
            if (commit is not None and stop_at_budget
                    and goal.budget_usd is not None
                    and cost + epoch_cost > goal.budget_usd):
                # the symmetric budget stop: break *before* committing the
                # epoch, so a min_time_budget goal never overspends (the
                # event path gates on the forecast above instead — its
                # epochs bill as they run)
                st.stop_reason = "budget"
                break
            if commit is not None:
                commit()      # deadline-skipped epochs are never billed
            t += wall
            cost += epoch_cost
            epochs_done += 1
            executed += 1
            events.append(TraceEvent(
                t, i, "epoch", throughput=samples_left / wall,
                workers=config.workers, memory_mb=config.memory_mb,
                batch_size=plan.batch_size,
                model_params=plan.workload.param_count, cost_cum=cost,
                restarts=restarts, failures=failures))
            i += 1

        st.next_epoch = i
        st.config = config
        st.last_sig = last_sig
        st.t, st.cost = t, cost
        st.t_prof, st.usd_prof = t_prof, usd_prof
        st.epochs_done = epochs_done
        st.rng_state = rng.get_state()
        if not paused and not st.stop_reason:
            st.stop_reason = "completed"
        st.done = not paused
        # snapshot the live lists: a later resumed slice keeps appending
        # to st.events/st.history, and must not retroactively mutate the
        # RunResult this slice returned
        return RunResult(events=list(events), wall_s=t,
                         cost_usd=cost - usd_prof,
                         profile_s=t_prof, profile_usd=usd_prof,
                         epochs_done=epochs_done,
                         config_history=list(history), state=st)
