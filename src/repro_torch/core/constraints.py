"""User-centric deployment goals (paper Section 3.2, Scenarios 1 & 2).

A copy of the JAX package's ``core/constraints.py``."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

# Convergence cost of stale gradients, as a fractional increase in the
# iterations needed to reach the same loss per unit of staleness bound
# (SSP analyses bound the error term linearly in the staleness; MLLess-style
# significance filters eat some of it, hence a small default slope).
SSP_PENALTY_PER_STEP = 0.02

# Convergence cost of top-k sparsification, as a fractional increase in
# iterations per decade of compression (error feedback keeps top-k SGD at
# the dense rate up to a residual term that grows as the keep ratio
# shrinks — Stich et al.; a 100x compression pays ~2 decades).
COMPRESSION_PENALTY_PER_DECADE = 0.08


def compression_inflation(ratio: float,
                          per_decade: float = COMPRESSION_PENALTY_PER_DECADE
                          ) -> float:
    """Multiplicative iteration-count inflation of a top-k keep ratio:
    dense (ratio >= 1) pays none; smaller ratios pay per decade of
    dropped mass. The Bayesian optimizer multiplies a candidate's
    predicted time *and* cost by this (exactly as
    ``staleness_inflation``), so a searched ``compress_ratio`` is judged
    on convergence-inflated totals, not just its cheaper wire bytes."""
    if ratio >= 1.0:
        return 1.0
    return 1.0 + per_decade * math.log10(1.0 / max(ratio, 1e-6))


def preemption_inflation(hazard_per_s: float,
                         ckpt_write_s: float = 2.0) -> float:
    """Multiplicative wall/cost inflation of running on a preemptible
    (spot) backend, at the hazard-aware Young–Daly checkpoint cadence
    ``tau* = sqrt(2 * ckpt_write_s / hazard)``: the checkpoint overhead
    ``ckpt/tau*`` plus the expected rework ``hazard * tau* / 2`` sum to
    ``sqrt(2 * hazard * ckpt_write_s)``. The Bayesian optimizer
    multiplies a spot candidate's predicted time and dollars by this, so
    the discount race against on-demand is judged net of preemptions."""
    if hazard_per_s <= 0.0 or ckpt_write_s <= 0.0:
        return 1.0
    return 1.0 + math.sqrt(2.0 * hazard_per_s * ckpt_write_s)


def staleness_inflation(sync_mode: str, staleness: int = 0,
                        n_workers: int = 1,
                        per_step: float = SSP_PENALTY_PER_STEP) -> float:
    """Multiplicative iteration-count inflation of a sync mode: bsp pays
    none; ssp(k) pays ``1 + per_step * k``; async has no bound, so its
    expected staleness is taken as the worst-case n-1 peers in flight.

    The Bayesian optimizer multiplies a candidate's predicted time *and*
    cost by this factor, so a ``Goal`` trade-off reflects convergence cost
    (more iterations to the same loss), not just the cheaper barrier-free
    wall-clock of one epoch."""
    from repro_torch.serverless.worker import parse_sync_mode
    mode, k = parse_sync_mode(sync_mode, staleness)
    if mode == "bsp":
        return 1.0
    if mode == "ssp":
        return 1.0 + per_step * max(k, 0)
    return 1.0 + per_step * max(n_workers - 1, 0)      # async


@dataclasses.dataclass(frozen=True)
class Goal:
    """What the user asked SMLT to optimize.

    kinds:
      "min_cost_deadline" — minimize $ s.t. training time <= deadline_s  (Scenario 1)
      "min_time_budget"   — minimize time s.t. $ <= budget_usd            (Scenario 2)
      "min_time"          — as fast as possible
      "min_cost"          — as cheap as possible
      "deadline_budget"   — minimize time s.t. time <= deadline_s AND
                            $ <= budget_usd — the workflow-level goal one
                            ``BudgetAllocator`` splits across a task DAG,
                            and the per-task grant it hands each task

    Constrained kinds validate their limit at construction: a
    "min_cost_deadline" without a deadline (or "deadline_budget" missing
    either limit) is a configuration bug, not a free-running goal.
    """
    kind: str
    deadline_s: Optional[float] = None
    budget_usd: Optional[float] = None

    _REQUIRED = {"min_cost_deadline": ("deadline_s",),
                 "min_time_budget": ("budget_usd",),
                 "deadline_budget": ("deadline_s", "budget_usd"),
                 "min_time": (), "min_cost": ()}

    def __post_init__(self):
        if self.kind not in self._REQUIRED:
            raise ValueError(f"unknown goal kind: {self.kind!r}")
        for field in self._REQUIRED[self.kind]:
            limit = getattr(self, field)
            if limit is None:
                raise ValueError(f"goal kind {self.kind!r} requires {field}")
            if limit <= 0:
                raise ValueError(f"goal {field} must be positive, "
                                 f"got {limit}")

    def objective_and_constraint(self, time_s: float, cost_usd: float,
                                 inflation: float = 1.0):
        """-> (objective value, constraint value or None, limit or None).

        ``inflation`` is the ssp-aware staleness penalty
        (``staleness_inflation``): the predicted epochs-to-converge scale
        by it, so both the time and the dollars a candidate config is
        judged on grow with its staleness bound.

        "deadline_budget" carries two limits; its constraint is the
        *binding* one, normalized — ``max(time/deadline, cost/budget)``
        against a limit of 1.0 — so the constrained-EI machinery needs no
        second constraint GP."""
        time_s = time_s * inflation
        cost_usd = cost_usd * inflation
        if self.kind == "min_cost_deadline":
            return cost_usd, time_s, self.deadline_s
        if self.kind == "min_time_budget":
            return time_s, cost_usd, self.budget_usd
        if self.kind == "deadline_budget":
            return time_s, max(time_s / self.deadline_s,
                               cost_usd / self.budget_usd), 1.0
        if self.kind == "min_time":
            return time_s, None, None
        if self.kind == "min_cost":
            return cost_usd, None, None
        raise ValueError(self.kind)
