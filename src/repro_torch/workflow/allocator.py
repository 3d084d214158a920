"""Workflow-level budget + deadline allocation (the "overarching view").

One workflow ``Goal`` (``deadline_budget``: deadline_s + budget_usd) is
split into per-task grants from ``epoch_estimate`` forecasts, and
*re-split on every task completion*: unspent grants return to the pool
(an early-stopped HPO loser's dollars are reclaimed), and the pool flows
preferentially to the forecast critical path. When the remaining time can
no longer fit the pending critical path, droppable tasks are dropped in
ascending priority.

A grant is also converted into a *worker-count window* — the dollars →
fleet-scale dial the per-task Bayesian optimizer then searches inside —
so re-allocation is visible as deployment shape: a task granted more
dollars is allowed (and, through its ``min_workers`` floor, pushed) to
run wider. That is how a reclaimed HPO budget turns into the winning
trial's final rung running with more workers than its first.

A copy of the JAX package's ``workflow/allocator.py`` (numpy only): the
same arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.bayes_opt import Config, ConfigSpace
from repro_torch.core.constraints import Goal
from repro_torch.core.probe_cache import DEFAULT_CACHE
from repro_torch.serverless.stores import ObjectStore, ParamStore
from repro_torch.workflow.dag import TaskSpec, WorkflowDAG


@dataclasses.dataclass(frozen=True)
class TaskForecast:
    """Closed-form forecast of one whole task (all epochs): the fastest
    achievable wall across the probe grid (deadline feasibility is judged
    on what scale-out *can* do) and the cheapest achievable cost (the
    floor a budget split must at least cover)."""
    wall_s: float
    cost_usd: float


@dataclasses.dataclass(frozen=True)
class TaskAllocation:
    """One task's slice of the workflow goal. ``deadline_s`` is absolute
    on the workflow clock; ``budget_usd`` is the task's whole-run grant;
    ``[min_workers, max_workers]`` is the fleet-scale window the task's
    ConfigSpace is narrowed to."""
    task: str
    budget_usd: float
    deadline_s: float
    min_workers: int
    max_workers: int


class BudgetAllocator:
    """Splits a global ``Goal(deadline_s, budget_usd)`` across a
    ``WorkflowDAG`` and re-splits as tasks finish.

    ``safety`` keeps a fraction of the budget ungranted as a reserve for
    forecast error (the event engine tracks the analytic forecast within
    ~1% at zero variance, but stragglers/failures overshoot it).
    ``cp_boost`` multiplies the grant weight of tasks on the forecast
    critical path, so reclaimed budget flows there first."""

    def __init__(self, dag: WorkflowDAG, goal: Goal,
                 param_store: ParamStore, object_store: ObjectStore, *,
                 space: Optional[ConfigSpace] = None, scheme: str = "hier",
                 memory_mb: int = 3072, safety: float = 0.8,
                 cp_boost: float = 2.0, bo_max_iters: int = 8,
                 profile_iters: int = 1):
        if goal.deadline_s is None or goal.budget_usd is None:
            raise ValueError("a workflow goal needs both deadline_s and "
                             "budget_usd (kind 'deadline_budget')")
        self.dag = dag
        self.goal = goal
        self.space = space or ConfigSpace()
        self.scheme = scheme
        self.memory_mb = min(max(memory_mb, self.space.min_memory),
                             self.space.max_memory)
        self.safety = safety
        self.cp_boost = cp_boost
        # per-task (n -> whole-task wall/cost) probe curves on a geometric
        # worker grid: the basis of forecasts and of the dollars->workers
        # conversion
        self._grid = self._worker_grid()
        self._curves: Dict[str, List[Tuple[int, float, float]]] = {
            t.name: self._curve(t, param_store, object_store) for t in dag}
        # what a task's Bayesian optimization itself costs before the
        # first epoch runs (``bo_max_iters`` probes of ``profile_iters``
        # iterations each, at a mid-space deployment): grants must cover
        # it, and the dollars->workers conversion spends only what is
        # left after it
        mem_probe = min(max((self.space.min_memory
                             + self.space.max_memory) // 2,
                            self.memory_mb), self.space.max_memory)
        n_probe = self._grid[len(self._grid) // 2]
        self._probe_usd: Dict[str, float] = {}
        for t in dag:
            if t.kind == "deploy":
                # a serving job runs no Bayesian optimization probes
                self._probe_usd[t.name] = 0.0
                continue
            _, usd, _ = DEFAULT_CACHE.profile_cost(
                t.workload, scheme,
                Config(n_probe, mem_probe, backend=t.backend),
                t.batch_size, param_store, object_store, profile_iters)
            self._probe_usd[t.name] = usd * bo_max_iters
        self.forecasts: Dict[str, TaskForecast] = {
            name: TaskForecast(
                wall_s=min(w for _, w, _ in curve),
                cost_usd=(min(c for _, _, c in curve)
                          + self._probe_usd[name]))
            for name, curve in self._curves.items()}

    def _worker_grid(self) -> List[int]:
        lo, hi = self.space.min_workers, self.space.max_workers
        grid, n = [], max(lo, 1)
        while n < hi:
            grid.append(n)
            n *= 2
        grid.append(hi)
        return sorted(set(grid))

    def _curve(self, t: TaskSpec, param_store: ParamStore,
               object_store: ObjectStore) -> List[Tuple[int, float, float]]:
        if t.kind == "deploy":
            # serving: wall is the stream's duration (autoscaling absorbs
            # load, it does not shorten the stream) and cost is the
            # closed-form ServingTask estimate — flat across the worker
            # grid, since serving scale is the admission policy's call
            wall, cost = t.serving.estimate()
            return [(n, wall, cost) for n in self._grid]
        out = []
        for n in self._grid:
            # a pinned task backend prices the curve at that target's
            # provisioning/flat-rate semantics (Config.backend flows
            # through cost_model._config_backend)
            est = DEFAULT_CACHE.epoch_estimate(t.workload, self.scheme,
                                 Config(n, self.memory_mb,
                                        backend=t.backend),
                                 t.batch_size,
                                 param_store, object_store,
                                 samples=t.samples)
            out.append((n, est.wall_s * t.epochs, est.cost_usd * t.epochs))
        return out

    # -- queries ---------------------------------------------------------------
    def forecast(self, name: str) -> TaskForecast:
        return self.forecasts[name]

    def workers_for_budget(self, name: str, budget_usd: float
                           ) -> Tuple[int, int]:
        """The fleet-scale window a grant affords: after setting aside the
        task's own profiling overhead, the widest probe-grid deployment
        whose forecast cost fits the remainder caps the search, and half
        of it floors it — so a doubled grant *shows up* as a wider fleet,
        not just headroom the optimizer may ignore."""
        epoch_budget = budget_usd - self._probe_usd[name]
        affordable = [n for n, _, c in self._curves[name]
                      if c <= epoch_budget]
        hi = max(affordable) if affordable else self._grid[0]
        lo = max(self.space.min_workers, hi // 2)
        return lo, hi

    # -- allocation ------------------------------------------------------------
    def allocate(self, *, now_s: float, spent_usd: float,
                 running: Dict[str, TaskAllocation],
                 finished: Set[str], dropped: Set[str],
                 ready: Sequence[str]
                 ) -> Tuple[Dict[str, TaskAllocation], List[str]]:
        """Grants for the ``ready`` tasks, given what already finished,
        what is running under an outstanding grant, and what was dropped.
        Returns ``(allocations, newly_dropped)``.

        Budget: pool = safety * budget - spent - outstanding grants, split
        over all unfinished tasks by ``cost_floor * priority * cp_boost``
        weight (ready tasks draw their share now; the rest stays reserved
        for successors). Deadline: each task must finish by
        ``deadline - tail``, its slack before the longest forecast chain
        of descendants. Tasks whose chain cannot fit the remaining time
        are resolved by dropping droppable tasks in ascending priority
        (dependents drop with them)."""
        settled = finished | dropped
        new_drops: List[str] = []
        pending = [n for n in self.dag.order
                   if n not in settled and n not in running]

        def chain_len(drops_so_far: Set[str]) -> float:
            walls = {n: self.forecasts[n].wall_s for n in pending
                     if n not in drops_so_far}
            return self.dag.critical_path(walls)[0]

        # deadline pressure: drop droppable pending tasks, lowest priority
        # first (latest in topo order breaks ties, so leaves go before the
        # trunks they depend on), until the pending critical path fits
        remaining_s = max(self.goal.deadline_s - now_s, 0.0)
        drops: Set[str] = set()
        while chain_len(drops) > remaining_s:
            cands = [n for n in pending
                     if n not in drops and self.dag[n].droppable]
            if not cands:
                break               # nothing droppable: deadline stops truncate
            victim = min(cands, key=lambda n: (self.dag[n].priority,
                                               -self.dag.order.index(n)))
            drops.add(victim)
            # a dropped task's descendants can never run
            drops |= {d for d in self.dag.descendants(victim)
                      if d in pending}
        new_drops = [n for n in self.dag.order if n in drops]
        pending = [n for n in pending if n not in drops]

        committed = sum(a.budget_usd for a in running.values())
        pool = max(self.goal.budget_usd * self.safety - spent_usd
                   - committed, 0.0)

        walls = {n: self.forecasts[n].wall_s for n in pending}
        for name, alloc in running.items():
            walls[name] = self.forecasts[name].wall_s
        cp = set(self.dag.critical_path(walls)[1])
        weight = {n: (self.forecasts[n].cost_usd
                      * max(self.dag[n].priority, 1)
                      * (self.cp_boost if n in cp else 1.0))
                  for n in pending}
        total_w = sum(weight.values())

        tails = self.dag.tails(walls)
        allocs: Dict[str, TaskAllocation] = {}
        for name in ready:
            if name in drops or name not in weight:
                continue
            grant = pool * weight[name] / total_w if total_w > 0 else 0.0
            deadline = max(self.goal.deadline_s - tails[name], now_s)
            lo, hi = self.workers_for_budget(name, grant)
            allocs[name] = TaskAllocation(task=name, budget_usd=grant,
                                          deadline_s=deadline,
                                          min_workers=lo, max_workers=hi)
        return allocs, new_drops
