"""User-centric deployment scenarios (paper Figs. 9-10) as a runnable demo;
the port's counterpart of the JAX package's ``examples/deadline_budget.py``.

Scenario 1: "finish within --deadline seconds, as cheap as possible."
Scenario 2: "spend at most --budget dollars, as fast as possible."
Scenario 3: a whole *workflow* — train -> fine-tune -> eval — under ONE
            deadline and ONE budget, split and re-split across the tasks
            by the workflow layer's BudgetAllocator.

Run:  PYTHONPATH=src python -m repro_torch.examples.deadline_budget \
          --deadline 3600 --budget 50
"""
import argparse

from repro_torch.core.constraints import Goal
from repro_torch.core.scheduler import EpochPlan
from repro_torch.serverless import WORKLOADS


def fresh_scheduler(scheme="hier", seed=0, max_workers=200):
    from repro_torch.core.bayes_opt import ConfigSpace
    from repro_torch.core.scheduler import TaskScheduler
    from repro_torch.serverless import ObjectStore, ParamStore, ServerlessPlatform
    plat = ServerlessPlatform(seed=seed)
    sched = TaskScheduler(plat, ObjectStore(), ParamStore(), scheme=scheme,
                          space=ConfigSpace(max_workers=max_workers),
                          seed=seed)
    return (sched, plat)


def show(title, res, goal):
    cfgs = [(c.workers, c.memory_mb) for c in res.config_history]
    print(f"\n{title}")
    print(f"  deployments: {cfgs[0]} (x{len(cfgs)} epochs)")
    print(f"  wall time:   {res.wall_s:,.0f} s "
          f"(profiling {res.profile_s:,.0f} s)")
    print(f"  cost:        ${res.total_cost:.2f} "
          f"(profiling ${res.profile_usd:.2f})")
    if goal.deadline_s:
        print(f"  deadline:    {goal.deadline_s:,.0f} s -> "
              f"{'MET' if res.wall_s <= goal.deadline_s else 'MISSED'} "
              f"({res.epochs_done} epochs trained)")
    if goal.budget_usd:
        print(f"  budget:      ${goal.budget_usd:.2f} -> "
              f"{'MET' if res.total_cost <= goal.budget_usd else 'MISSED'}")


def show_workflow(title, res, goal):
    print(f"\n{title}")
    for name in res.tasks:
        r = res.tasks[name]
        cfg = res.config_of(name)
        grant = res.allocations[name].budget_usd
        print(f"  {name:<10} [{res.start_s[name]:7.0f}s ->"
              f" {res.finish_s[name]:7.0f}s]  epochs={r.epochs_done}"
              f"  workers={cfg.workers if cfg else 0:>3}"
              f"  ${r.total_cost:6.3f} of ${grant:6.3f} granted")
    print(f"  workflow:    {res.wall_s:,.0f} s, ledger ${res.ledger_usd:.2f}"
          f" (deadline {goal.deadline_s:,.0f} s ->"
          f" {'MET' if res.wall_s <= goal.deadline_s else 'MISSED'};"
          f" budget ${goal.budget_usd:.2f} ->"
          f" {'MET' if res.ledger_usd <= goal.budget_usd else 'MISSED'})")


def run_workflow(args):
    from repro_torch.core.bayes_opt import ConfigSpace
    from repro_torch.serverless import ObjectStore, ParamStore, ServerlessPlatform
    from repro_torch.workflow import TaskSpec, WorkflowDAG, WorkflowOrchestrator
    w = WORKLOADS[args.model]
    small = max(args.samples // 4, 1024)
    dag = WorkflowDAG([
        TaskSpec("train", w, epochs=max(args.epochs - 2, 1),
                 batch_size=1024, samples=args.samples),
        TaskSpec("finetune", w, epochs=1, batch_size=1024, samples=small,
                 deps=("train",), kind="finetune", warm_start_from="train",
                 priority=2),
        TaskSpec("eval", w, epochs=1, batch_size=1024, samples=small,
                 deps=("finetune",), kind="eval"),
    ])
    goal = Goal("deadline_budget", deadline_s=args.deadline,
                budget_usd=args.budget)
    orch = WorkflowOrchestrator(
        dag, goal, ServerlessPlatform(seed=0), ObjectStore(), ParamStore(),
        space=ConfigSpace(max_workers=200), engine="analytic", seed=0)
    return orch.run(), goal


def main(argv=None):
    """Returns Scenarios 1 and 2's ``RunResult``s and Scenario 3's
    ``WorkflowResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--deadline", type=float, default=3600.0)
    ap.add_argument("--budget", type=float, default=50.0)
    ap.add_argument("--model", default="bert-medium",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--samples", type=int, default=25_000)
    args = ap.parse_args(argv)

    w = WORKLOADS[args.model]
    plans = [EpochPlan(1024, w, samples=args.samples)
             for _ in range(args.epochs)]

    goal1 = Goal("min_cost_deadline", deadline_s=args.deadline)
    sched, *_ = fresh_scheduler("hier")
    res1 = sched.run(plans, goal1, stop_at_deadline=True)
    show(f"Scenario 1 — min cost s.t. T <= {args.deadline:.0f}s "
         f"({args.model})", res1, goal1)

    goal2 = Goal("min_time_budget", budget_usd=args.budget)
    sched, *_ = fresh_scheduler("hier")
    res2 = sched.run(plans, goal2, stop_at_budget=True)
    show(f"Scenario 2 — min time s.t. $ <= {args.budget:.0f} "
         f"({args.model})", res2, goal2)

    res3, goal3 = run_workflow(args)
    show_workflow("Scenario 3 — train -> fine-tune -> eval workflow under "
                  f"one goal (T <= {goal3.deadline_s:.0f}s, "
                  f"$ <= {goal3.budget_usd:.0f})", res3, goal3)
    return res1, res2, res3


if __name__ == "__main__":
    main()
