"""Typed task DAGs for ML design workflows (paper Sections 1 and 3.1).

SMLT frames ML design and training as a *continuous workflow of various
tasks with dynamic resource demands* — hyper-parameter trials, NAS
candidates, fine-tunes, evaluations — executed user-centrically under one
deadline and one budget. ``TaskSpec`` is one node of that workflow;
``WorkflowDAG`` is the validated dependency graph the
``WorkflowOrchestrator`` walks and the ``BudgetAllocator`` splits the
global ``Goal`` across.

A copy of the JAX package's ``workflow/dag.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.constraints import Goal
from repro_torch.core.scheduler import EpochPlan
from repro_torch.serverless.arrivals import ServingTask
from repro_torch.serverless.worker import Workload

# "deploy" serves the current model as an event-engine ServingJob on the
# workflow's shared domain; "online_update" is a continuous fine-tune on
# freshly arrived samples (an OnlineStream window) — together they close
# the paper's train -> eval -> deploy -> continuous-fine-tune loop.
TASK_KINDS = ("train", "finetune", "eval", "hpo", "nas", "deploy",
              "online_update")


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One task of the workflow: a training/fine-tune/eval job with its
    workload, epoch count, dependencies, and scheduling metadata.

    ``priority`` weights the allocator's budget split (and decides what
    survives deadline pressure: ``droppable`` tasks are dropped in
    ascending priority). ``goal`` overrides the allocator's per-task
    grant with an explicit user goal. ``warm_start_from`` names a task —
    or an ``HPOSweep`` — whose winning config seeds this task's Bayesian
    optimization. ``sweep``/``rung``/``slot`` are HPO bookkeeping filled
    in by ``repro_torch.workflow.tuner.expand_hpo``.

    A ``deploy`` task carries a :class:`ServingTask` in ``serving`` and
    executes as an event-engine ``ServingJob`` instead of a
    ``TaskScheduler`` run (``workload`` then names the *served* model).
    An ``online_update`` task runs the training path on the samples that
    arrived since the last update (the caller sizes ``samples`` from its
    arrival stream).

    ``backend`` pins the task to an execution target from
    ``repro_torch.serverless.backends.BACKENDS`` ("vm", "gpu_vm", ...): the
    allocator forecasts the task at that backend's rates and the
    orchestrator runs it there. "" leaves the choice to the scheduler's
    config search (serverless unless the space searches backends)."""
    name: str
    workload: Workload
    epochs: int = 1
    batch_size: int = 1024
    samples: Optional[int] = None
    deps: Tuple[str, ...] = ()
    priority: int = 1
    goal: Optional[Goal] = None
    kind: str = "train"
    droppable: bool = False
    warm_start_from: Optional[str] = None
    sweep: Optional[str] = None
    rung: int = -1
    slot: int = -1
    serving: Optional[ServingTask] = None
    backend: str = ""

    def __post_init__(self):
        object.__setattr__(self, "deps", tuple(self.deps))
        if not self.name:
            raise ValueError("TaskSpec needs a name")
        if self.kind not in TASK_KINDS:
            raise ValueError(f"unknown task kind: {self.kind!r}")
        if self.kind == "deploy" and self.serving is None:
            raise ValueError(f"{self.name}: a deploy task needs a "
                             "ServingTask in `serving`")
        if self.kind != "deploy" and self.serving is not None:
            raise ValueError(f"{self.name}: `serving` is only valid on "
                             "deploy tasks")
        if self.epochs < 1:
            raise ValueError(f"{self.name}: epochs must be >= 1")
        if self.batch_size < 1:
            raise ValueError(f"{self.name}: batch_size must be >= 1")
        if self.name in self.deps:
            raise ValueError(f"{self.name}: depends on itself")

    def plans(self) -> List[EpochPlan]:
        if self.kind == "deploy":
            raise ValueError(f"{self.name}: deploy tasks run as a "
                             "ServingJob, not as epoch plans")
        return [EpochPlan(self.batch_size, self.workload,
                          samples=self.samples) for _ in range(self.epochs)]


class WorkflowDAG:
    """A validated task DAG: unique names, existing dependencies, no
    cycles. ``order`` is a deterministic topological order (ties broken
    by declaration order), the basis of every allocator/orchestrator
    iteration — so a workflow's schedule is reproducible run to run."""

    def __init__(self, tasks: Sequence[TaskSpec]):
        self.tasks: Dict[str, TaskSpec] = {}
        for t in tasks:
            if t.name in self.tasks:
                raise ValueError(f"duplicate task name: {t.name!r}")
            self.tasks[t.name] = t
        for t in tasks:
            for d in t.deps:
                if d not in self.tasks:
                    raise ValueError(f"{t.name}: unknown dependency {d!r}")
        self._succ: Dict[str, List[str]] = {n: [] for n in self.tasks}
        for t in tasks:
            for d in t.deps:
                self._succ[d].append(t.name)
        self.order = self._topo_order()

    def _topo_order(self) -> List[str]:
        indeg = {n: len(t.deps) for n, t in self.tasks.items()}
        queue = [n for n in self.tasks if indeg[n] == 0]  # declaration order
        order: List[str] = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for s in self._succ[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    queue.append(s)
        if len(order) != len(self.tasks):
            stuck = sorted(n for n in self.tasks if indeg[n] > 0)
            raise ValueError("workflow has a dependency cycle through "
                             f"{stuck}")
        return order

    # -- graph queries -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.tasks)

    def __iter__(self):
        return iter(self.tasks.values())

    def __contains__(self, name: str) -> bool:
        return name in self.tasks

    def __getitem__(self, name: str) -> TaskSpec:
        return self.tasks[name]

    def successors(self, name: str) -> List[str]:
        return list(self._succ[name])

    def descendants(self, name: str) -> Set[str]:
        """Everything transitively downstream of ``name`` (exclusive)."""
        out: Set[str] = set()
        stack = list(self._succ[name])
        while stack:
            n = stack.pop()
            if n not in out:
                out.add(n)
                stack.extend(self._succ[n])
        return out

    def ready(self, done: Iterable[str],
              exclude: Iterable[str] = ()) -> List[TaskSpec]:
        """Tasks whose dependencies are all in ``done``, excluding
        ``exclude`` (running/dropped) and ``done`` itself — in
        topological order."""
        done, exclude = set(done), set(exclude)
        return [self.tasks[n] for n in self.order
                if n not in done and n not in exclude
                and all(d in done for d in self.tasks[n].deps)]

    # -- forecast-weighted paths --------------------------------------------
    def tails(self, wall_s: Dict[str, float]) -> Dict[str, float]:
        """Longest forecast path strictly *after* each task: the time that
        must still fit between a task's finish and the global deadline.
        Tasks missing from ``wall_s`` (finished/dropped) contribute 0."""
        tails: Dict[str, float] = {}
        for n in reversed(self.order):
            t = 0.0
            for s in self._succ[n]:
                t = max(t, wall_s.get(s, 0.0) + tails[s])
            tails[n] = t
        return tails

    def critical_path(self, wall_s: Dict[str, float]
                      ) -> Tuple[float, List[str]]:
        """The longest forecast chain (length, member tasks) over the
        tasks present in ``wall_s`` — where re-allocated budget flows
        first."""
        tails = self.tails(wall_s)
        best_len, best_head = 0.0, None
        for n in self.order:
            if n not in wall_s:
                continue
            # heads are tasks with no unfinished predecessors in wall_s
            if any(d in wall_s for d in self.tasks[n].deps):
                continue
            length = wall_s[n] + tails[n]
            if length > best_len:
                best_len, best_head = length, n
        if best_head is None:
            return 0.0, []
        path, n = [best_head], best_head
        while True:
            nxt, nxt_len = None, -1.0
            for s in self._succ[n]:
                if s in wall_s and wall_s[s] + tails[s] > nxt_len:
                    nxt, nxt_len = s, wall_s[s] + tails[s]
            if nxt is None:
                return best_len, path
            path.append(nxt)
            n = nxt
