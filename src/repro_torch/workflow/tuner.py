"""The "ML design" half of the workflow layer: successive-halving HPO.

An ``HPOSweep`` expands into a rung-structured sub-DAG
(``expand_hpo``): rung 0 runs every trial for a few epochs; each later
rung has ``n_trials / eta**rung`` *survivor slots* that depend on the
whole previous rung. Which trial occupies a slot is decided at runtime
by ``SuccessiveHalving``: when a slot becomes ready the top-scoring
survivors of the previous rung are assigned in rank order, each
warm-starting its Bayesian optimization from the config its previous
rung actually deployed (the scheduler's existing ``warm_start=`` hook).
Early-stopped losers simply have no later-rung task — the budget they
would have burned returns to the allocator's pool and flows to the
surviving rungs and the critical path.

Trial quality is a seeded synthetic loss curve (monotone improving in
epochs trained, deterministic per trial): the tuner under test is the
*resource allocation* — which trials get how many epochs and dollars —
not the model zoo.

A copy of the JAX package's ``workflow/tuner.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bayes_opt import Config
from repro_torch.core.rng import curve_stream
from repro_torch.serverless.worker import Workload
from repro_torch.workflow.dag import TaskSpec


@dataclasses.dataclass(frozen=True)
class HPOSweep:
    """A successive-halving hyper-parameter sweep over one workload.

    ``n_trials`` trials start in rung 0; each subsequent rung keeps the
    best ``1/eta`` fraction, for ``rungs`` rungs total. Every rung task
    trains ``epochs_per_rung`` epochs of ``samples`` samples."""
    name: str
    workload: Workload
    n_trials: int = 8
    rungs: int = 2
    eta: int = 2
    epochs_per_rung: int = 1
    batch_size: int = 1024
    samples: Optional[int] = None
    deps: Tuple[str, ...] = ()
    priority: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.n_trials < self.eta:
            raise ValueError("n_trials must be >= eta")
        if self.rungs < 1 or self.eta < 2:
            raise ValueError("need rungs >= 1 and eta >= 2")
        if self.n_trials // self.eta ** (self.rungs - 1) < 1:
            raise ValueError("halving schedule leaves an empty final rung")

    def survivors(self, rung: int) -> int:
        """How many trials run in ``rung`` (rung 0 = all trials)."""
        return max(self.n_trials // self.eta ** rung, 1)

    def task_name(self, rung: int, slot: int) -> str:
        kind = "t" if rung == 0 else "s"
        return f"{self.name}:r{rung}:{kind}{slot}"


def expand_hpo(sweep: HPOSweep, *, droppable: bool = True) -> List[TaskSpec]:
    """The sweep's static sub-DAG: rung-0 trial tasks (one per trial) and
    later-rung survivor slots, each rung depending on the entire previous
    rung (the selection barrier). Feed the specs into a ``WorkflowDAG``
    alongside any downstream fine-tune/eval tasks (see
    ``sweep_final_tasks`` for their deps)."""
    specs: List[TaskSpec] = []
    prev_rung: Tuple[str, ...] = sweep.deps
    for rung in range(sweep.rungs):
        names = []
        for slot in range(sweep.survivors(rung)):
            name = sweep.task_name(rung, slot)
            specs.append(TaskSpec(
                name=name, workload=sweep.workload,
                epochs=sweep.epochs_per_rung, batch_size=sweep.batch_size,
                samples=sweep.samples, deps=prev_rung,
                # later rungs concentrate the surviving budget: weight them
                # up so the allocator's split mirrors the halving shape
                priority=sweep.priority * (rung + 1),
                kind="hpo", droppable=droppable, sweep=sweep.name,
                rung=rung, slot=slot))
            names.append(name)
        prev_rung = tuple(names)
    return specs


def sweep_final_tasks(sweep: HPOSweep) -> Tuple[str, ...]:
    """The names of the sweep's final rung — what a dependent fine-tune
    task should declare as its ``deps``."""
    last = sweep.rungs - 1
    return tuple(sweep.task_name(last, s) for s in range(sweep.survivors(last)))


def trial_curves(sweep: HPOSweep) -> Tuple[np.ndarray, np.ndarray]:
    """The sweep's deterministic per-trial loss-curve parameters
    ``(quality, floor)``: trial *i* after *e* epochs sits at
    ``floor[i] + quality[i] / (1 + e)``. Shared by ``SuccessiveHalving``
    and by baselines (e.g. uniform-budget HPO) that must be judged on the
    *same* trials."""
    rng = curve_stream(sweep.seed)
    quality = rng.uniform(0.2, 1.0, size=sweep.n_trials)
    floor = rng.uniform(0.01, 0.05, size=sweep.n_trials)
    return quality, floor


def trial_loss(sweep: HPOSweep, trial: int, epochs: int) -> float:
    quality, floor = trial_curves(sweep)
    return float(floor[trial] + quality[trial] / (1.0 + epochs))


class SuccessiveHalving:
    """Runtime controller of one sweep: assigns trials to survivor slots,
    records per-trial progress, and scores trials on a deterministic
    synthetic loss curve ``loss_i(e) = floor + q_i / (1 + e)`` (``q_i``
    seeded per trial, ``e`` = epochs trained). Selection, warm-start
    configs, and the final winner all derive from it reproducibly."""

    def __init__(self, sweep: HPOSweep):
        self.sweep = sweep
        self.epochs: Dict[int, int] = {i: 0 for i in range(sweep.n_trials)}
        self.scores: Dict[int, float] = {}
        self.assignment: Dict[str, int] = {}     # task name -> trial id
        self.configs: Dict[int, Config] = {}     # trial -> last deployment
        self._rung_members: Dict[int, List[int]] = {}

    def loss(self, trial: int, epochs: Optional[int] = None) -> float:
        e = self.epochs[trial] if epochs is None else epochs
        return trial_loss(self.sweep, trial, e)

    # -- slot assignment -----------------------------------------------------
    def assign(self, spec: TaskSpec) -> int:
        """The trial that runs in ``spec`` (a task of this sweep): rung-0
        tasks are their own trial; a later-rung slot takes the slot-th
        best scorer among the previous rung's participants."""
        if spec.sweep != self.sweep.name:
            raise ValueError(f"{spec.name} is not a task of sweep "
                             f"{self.sweep.name!r}")
        if spec.name in self.assignment:
            return self.assignment[spec.name]
        if spec.rung == 0:
            trial = spec.slot
        else:
            ranked = self.survivors_of(spec.rung - 1)
            if spec.slot >= len(ranked):
                raise RuntimeError(f"{spec.name}: rung {spec.rung - 1} has "
                                   f"only {len(ranked)} scored trials")
            trial = ranked[spec.slot]
        self.assignment[spec.name] = trial
        self._rung_members.setdefault(spec.rung, []).append(trial)
        return trial

    def survivors_of(self, rung: int) -> List[int]:
        """Previous-rung participants ranked best-first (ties broken by
        trial id, so ranking is deterministic)."""
        members = self._rung_members.get(rung, [])
        return sorted((t for t in members if t in self.scores),
                      key=lambda t: (self.scores[t], t))

    # -- progress reporting --------------------------------------------------
    def report(self, spec: TaskSpec, epochs_done: int,
               config: Optional[Config]) -> float:
        """Record a finished rung task: credit the trial's epochs, refresh
        its score, and remember its deployed config for the next rung's
        warm start. Returns the trial's current loss."""
        trial = self.assign(spec)
        self.epochs[trial] += max(epochs_done, 0)
        self.scores[trial] = self.loss(trial)
        if config is not None:
            self.configs[trial] = config
        return self.scores[trial]

    def warm_config(self, spec: TaskSpec) -> Optional[Config]:
        """The config the slot's trial deployed in its previous rung."""
        return self.configs.get(self.assign(spec))

    def best(self) -> Tuple[int, float]:
        """(winner trial, loss) over everything scored so far."""
        if not self.scores:
            raise RuntimeError("no trials scored yet")
        trial = min(self.scores, key=lambda t: (self.scores[t], t))
        return trial, self.scores[trial]
