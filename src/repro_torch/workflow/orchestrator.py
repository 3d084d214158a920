"""Workflow orchestrator: a DAG of ML tasks under one deadline + budget.

This is the layer the paper promises in Sections 1/3.1 — the
*overarching view* over a continuous workflow of design and training
tasks — built on everything below it:

  - each task runs as its own ``TaskScheduler`` job (Bayesian
    optimization, mid-epoch adaptation, deadline/budget stops), driven
    through the scheduler's generator form (``TaskScheduler.drive``);
  - ready tasks execute *concurrently*: every event-engine chunk a task
    needs is admitted into one shared ``ContentionDomain`` at the task's
    workflow-clock offset, so co-running tasks contend on the same
    stores/links and bill one shared platform ledger (per-task
    attribution via ``ledger.job_usd``);
  - a ``BudgetAllocator`` splits the global ``Goal`` into per-task
    grants/deadlines/worker windows and *re-allocates on every task
    completion* — unspent and early-stopped budget flows to the critical
    path, and deadline pressure drops droppable tasks by priority;
  - ``SuccessiveHalving`` tuners resolve HPO survivor slots at runtime,
    warm-starting each rung's BO from the trial's previous deployment.

Everything is seeded: two runs with the same DAG and seed produce
bit-identical workflow traces (``WorkflowResult.trace``).

A copy of the JAX package's ``workflow/orchestrator.py`` (numpy only):
the same arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.bayes_opt import Config, ConfigSpace
from repro_torch.core.constraints import Goal
from repro_torch.core.scheduler import RunResult, TaskScheduler
from repro_torch.serverless.arrivals import RequestStream
from repro_torch.serverless.events import ContentionDomain, ServingJob, ServingResult
from repro_torch.serverless.platform import ServerlessPlatform
from repro_torch.serverless.stores import ObjectStore, ParamStore
from repro_torch.workflow.allocator import BudgetAllocator, TaskAllocation
from repro_torch.workflow.dag import TaskSpec, WorkflowDAG
from repro_torch.workflow.tuner import HPOSweep, SuccessiveHalving


@dataclasses.dataclass
class WorkflowResult:
    """What one orchestrated workflow produced."""
    tasks: Dict[str, RunResult]
    start_s: Dict[str, float]
    finish_s: Dict[str, float]
    wall_s: float                       # makespan over the task schedule
    cost_usd: float                     # sum of per-task totals
    ledger_usd: float                   # the shared platform's actual bill
    dropped: List[str]
    allocations: Dict[str, TaskAllocation]
    assignments: Dict[str, int]         # HPO task -> trial id
    winners: Dict[str, Tuple[int, float]]   # sweep -> (trial, loss)
    trace: List[str]                    # deterministic workflow event log
    # deploy tasks keep their full serving detail (latency percentiles,
    # cold starts, fleet peak) alongside the RunResult stub in ``tasks``
    serving: Dict[str, ServingResult] = dataclasses.field(
        default_factory=dict)

    def config_of(self, name: str) -> Optional[Config]:
        hist = self.tasks[name].config_history
        return hist[-1] if hist else None


class _TaskRun:
    __slots__ = ("spec", "gen", "alloc", "start_t", "primed")

    def __init__(self, spec: TaskSpec, gen, alloc: TaskAllocation,
                 start_t: float):
        self.spec = spec
        self.gen = gen
        self.alloc = alloc
        self.start_t = start_t
        self.primed = False


class WorkflowOrchestrator:
    def __init__(self, dag: WorkflowDAG, goal: Goal,
                 platform: ServerlessPlatform, object_store: ObjectStore,
                 param_store: ParamStore, *,
                 space: Optional[ConfigSpace] = None, scheme: str = "hier",
                 engine: str = "event", engine_opts: Optional[Dict] = None,
                 sweeps: Sequence[HPOSweep] = (), seed: int = 0,
                 allocator: Optional[BudgetAllocator] = None,
                 profile_iters: int = 1, bo_max_iters: int = 8,
                 mid_epoch_adapt: bool = False,
                 record_trace: bool = False):
        self.dag = dag
        self.goal = goal
        self.platform = platform
        self.object_store = object_store
        self.param_store = param_store
        self.space = space or ConfigSpace()
        self.scheme = scheme
        self.engine = engine
        self.engine_opts = dict(engine_opts or {})
        # perf default: a workflow co-simulates many engines — per-event
        # trace lines are for debugging single tasks, so they are opt-in
        if record_trace and "record_trace" not in self.engine_opts:
            self.engine_opts["record_trace"] = True
        self.seed = seed
        self.profile_iters = profile_iters
        self.bo_max_iters = bo_max_iters
        self.mid_epoch_adapt = mid_epoch_adapt
        self.allocator = allocator or BudgetAllocator(
            dag, goal, param_store, object_store, space=self.space,
            scheme=scheme, bo_max_iters=bo_max_iters,
            profile_iters=profile_iters)
        self.tuners: Dict[str, SuccessiveHalving] = {
            s.name: SuccessiveHalving(s) for s in sweeps}
        for spec in dag:
            if spec.sweep is not None and spec.sweep not in self.tuners:
                raise ValueError(f"{spec.name} belongs to sweep "
                                 f"{spec.sweep!r} but no such HPOSweep was "
                                 "passed to the orchestrator")

        self.domain = ContentionDomain()
        self._running: Dict[str, _TaskRun] = {}
        self._finished: Dict[str, RunResult] = {}
        self._start_t: Dict[str, float] = {}
        self._finish_t: Dict[str, float] = {}
        self._dropped: Set[str] = set()
        self._serving: Dict[str, ServingResult] = {}
        self._allocs: Dict[str, TaskAllocation] = {}
        self._spent = 0.0
        self._trace: List[str] = []
        self._admitting = False
        self._admit_again = False
        self._ran = False

    # -- public ----------------------------------------------------------------
    def run(self) -> WorkflowResult:
        if self._ran:
            raise RuntimeError("a WorkflowOrchestrator runs once")
        self._ran = True
        self._admit_ready()
        self.domain.run()
        leftover = [n for n in self.dag.order
                    if n not in self._finished and n not in self._dropped]
        if leftover:
            raise RuntimeError(f"workflow stalled: {leftover} neither "
                               "finished nor dropped")
        winners = {}
        for name, tuner in self.tuners.items():
            if tuner.scores:
                trial, loss = tuner.best()
                winners[name] = (trial, loss)
                self._log(self._wall(), f"winner {name} trial={trial} "
                                        f"loss={loss:.6f}")
        assignments = {}
        for tuner in self.tuners.values():
            assignments.update(tuner.assignment)
        return WorkflowResult(
            tasks=dict(self._finished), start_s=dict(self._start_t),
            finish_s=dict(self._finish_t), wall_s=self._wall(),
            cost_usd=sum(r.total_cost for r in self._finished.values()),
            ledger_usd=self.platform.ledger.total_cost,
            dropped=[n for n in self.dag.order if n in self._dropped],
            allocations=dict(self._allocs), assignments=assignments,
            winners=winners, trace=list(self._trace),
            serving=dict(self._serving))

    # -- internals -------------------------------------------------------------
    def _wall(self) -> float:
        return max(self._finish_t.values(), default=0.0)

    def _log(self, t: float, line: str):
        self._trace.append(f"{t:.6f} {line}")

    def _task_seed(self, name: str) -> int:
        return (self.seed * 1_000_003 + zlib.crc32(name.encode())) % 2**31

    def _admit_ready(self):
        """Start every task whose dependencies are done, allocating its
        budget/deadline/worker window first. Re-entrant-safe: a task that
        finishes synchronously while being started (analytic engine, or a
        goal that stops before the first epoch) queues another admission
        round instead of recursing."""
        if self._admitting:
            self._admit_again = True
            return
        self._admitting = True
        try:
            while True:
                self._admit_again = False
                started = self._admit_once()
                if not started and not self._admit_again:
                    break
        finally:
            self._admitting = False

    def _admit_once(self) -> bool:
        # (_drop cascades through descendants, so a task with a dropped
        # dependency is itself already in _dropped and never shows here)
        ready = self.dag.ready(self._finished,
                               exclude=set(self._running) | self._dropped)
        if not ready:
            return False
        now = self.domain.now
        allocs, drops = self.allocator.allocate(
            now_s=now, spent_usd=self._spent,
            running={n: tr.alloc for n, tr in self._running.items()},
            finished=set(self._finished), dropped=set(self._dropped),
            ready=[r.name for r in ready])
        for name in drops:
            self._drop(name, "deadline pressure")
        started = False
        for spec in ready:
            if spec.name in self._dropped or spec.name not in allocs:
                continue
            self._start_task(spec, allocs[spec.name])
            started = True
        return started

    def _drop(self, name: str, reason: str):
        if name in self._dropped or name in self._finished:
            return
        self._dropped.add(name)
        self._log(self.domain.now, f"drop {name} ({reason})")
        for d in self.dag.descendants(name):
            self._drop(d, "dependency dropped")

    def _warm_config(self, spec: TaskSpec) -> Optional[Config]:
        if spec.sweep is not None:
            tuner = self.tuners[spec.sweep]
            trial = tuner.assign(spec)
            self._log(self.domain.now, f"assign {spec.name} trial={trial}")
            return tuner.warm_config(spec)
        src = spec.warm_start_from
        if src is None:
            return None
        if src in self.tuners:                   # a sweep: warm from winner
            tuner = self.tuners[src]
            if tuner.scores:
                return tuner.configs.get(tuner.best()[0])
            return None
        if src in self._finished:
            hist = self._finished[src].config_history
            return hist[-1] if hist else None
        return None

    def _start_task(self, spec: TaskSpec, alloc: TaskAllocation):
        start_t = max([self._finish_t[d] for d in spec.deps], default=0.0)
        start_t = max(start_t, 0.0)
        self._start_t[spec.name] = start_t
        self._allocs[spec.name] = alloc
        if spec.kind == "deploy":
            self._start_serving(spec, alloc, start_t)
            return
        warm = self._warm_config(spec)
        space = dataclasses.replace(self.space,
                                    min_workers=alloc.min_workers,
                                    max_workers=alloc.max_workers)
        # per-task engine opts: the allocator's task priority becomes the
        # training job's SharedLink flow priority (water-filling weight
        # against co-running tasks and serving traffic on the same
        # domain), and a pinned task backend overrides the search
        opts = dict(self.engine_opts)
        if "link_priority" not in opts:
            opts["link_priority"] = float(max(spec.priority, 1))
        if spec.backend and "backend" not in opts:
            opts["backend"] = spec.backend
        sched = TaskScheduler(
            self.platform, self.object_store, self.param_store,
            space=space, scheme=self.scheme,
            profile_iters=self.profile_iters,
            bo_max_iters=self.bo_max_iters,
            seed=self._task_seed(spec.name), engine=self.engine,
            engine_opts=opts,
            mid_epoch_adapt=self.mid_epoch_adapt, job=spec.name)
        # the task's own goal wins; otherwise its slice of the workflow
        # goal, with the absolute allocation deadline made task-relative
        goal = spec.goal or Goal("deadline_budget",
                                 deadline_s=max(alloc.deadline_s - start_t,
                                                1e-9),
                                 budget_usd=max(alloc.budget_usd, 1e-9))
        self._log(start_t,
                  f"start {spec.name} budget={alloc.budget_usd:.6f} "
                  f"deadline={alloc.deadline_s:.6f} "
                  f"workers={alloc.min_workers}-{alloc.max_workers}")
        gen = sched.drive(spec.plans(), goal, adaptive=True,
                          stop_at_deadline=True, stop_at_budget=True,
                          warm_start=warm)
        tr = _TaskRun(spec, gen, alloc, start_t)
        self._running[spec.name] = tr
        self._pump(tr, None)

    def _pump(self, tr: _TaskRun, value):
        """Advance a task's scheduler generator to its next engine request
        (admitting the engine into the shared domain at the task's current
        workflow time) or to completion."""
        try:
            if not tr.primed:
                tr.primed = True
                req = next(tr.gen)
            else:
                req = tr.gen.send(value)
        except StopIteration as stop:
            self._finish_task(tr, stop.value)
            return
        req.build(domain=self.domain,
                  start_at=tr.start_t + req.at_t,
                  on_complete=lambda eng, tr=tr: self._engine_done(tr, eng))

    def _engine_done(self, tr: _TaskRun, eng):
        self._pump(tr, eng.result())

    def _start_serving(self, spec: TaskSpec, alloc: TaskAllocation,
                       start_t: float):
        """Admit a ``deploy`` task as a ``ServingJob`` on the shared
        domain: inference traffic contends with every co-running
        training job on the same stores/links and bills the same
        ledger (``ServingJob.result`` self-attributes)."""
        sv = spec.serving
        arr = RequestStream(sv.arrivals,
                            seed=self._task_seed(spec.name)).arrivals(
            start_t, sv.duration_s)
        self._log(start_t,
                  f"serve {spec.name} requests={len(arr)} "
                  f"rate={sv.arrivals.mean_rps():.3f} "
                  f"budget={alloc.budget_usd:.6f}")
        tr = _TaskRun(spec, None, alloc, start_t)
        self._running[spec.name] = tr
        ServingJob(
            sv.policy, arr, sv.flops_per_request,
            self.param_store, self.object_store,
            domain=self.domain, platform=self.platform,
            model_bytes=sv.model_bytes, code_bytes=sv.code_bytes,
            cold_start_s=sv.cold_start_s, keep_warm_s=sv.keep_warm_s,
            max_instances=sv.max_instances,
            refresh_every_s=sv.refresh_every_s,
            link_priority=sv.link_priority, slo_s=sv.slo_s,
            job=spec.name, start_at=start_t,
            on_complete=lambda job, tr=tr: self._finish_serving(tr, job))

    def _finish_serving(self, tr: _TaskRun, job: ServingJob):
        name = tr.spec.name
        res = job.result()          # charges store + attributes the job
        self._serving[name] = res
        del self._running[name]
        # a RunResult stub so deploy tasks flow through the same
        # bookkeeping (finish times, spent budget, dependents) as
        # training tasks; the serving detail lives in ``serving``
        self._finished[name] = RunResult(
            events=[], wall_s=res.wall_s, cost_usd=res.cost_usd,
            profile_s=0.0, profile_usd=0.0, epochs_done=1,
            config_history=[])
        t_end = tr.start_t + res.wall_s
        self._finish_t[name] = t_end
        self._spent += res.cost_usd
        self._log(t_end,
                  f"served {name} wall={res.wall_s:.6f} "
                  f"cost={res.cost_usd:.6f} requests={res.requests} "
                  f"p99={res.p99_s:.6f} cold={res.cold_starts} "
                  f"peak={res.peak_instances}")
        self._admit_ready()

    def _finish_task(self, tr: _TaskRun, result: RunResult):
        name = tr.spec.name
        del self._running[name]
        self._finished[name] = result
        t_end = tr.start_t + result.wall_s
        self._finish_t[name] = t_end
        self._spent += result.total_cost
        cfg = result.config_history[-1] if result.config_history else None
        if tr.spec.sweep is not None:
            loss = self.tuners[tr.spec.sweep].report(
                tr.spec, result.epochs_done, cfg)
            self._log(t_end, f"score {name} loss={loss:.6f}")
        self._log(t_end,
                  f"done {name} wall={result.wall_s:.6f} "
                  f"cost={result.total_cost:.6f} "
                  f"epochs={result.epochs_done} "
                  f"stop={result.stop_reason} "
                  f"workers={cfg.workers if cfg else 0}")
        self._admit_ready()
