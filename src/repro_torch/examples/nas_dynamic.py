"""Adaptive workflows demo: dynamic batching + NAS (paper Figs. 12-13); the
port's counterpart of the JAX package's ``examples/nas_dynamic.py``.

Shows the task scheduler's training-dynamics monitoring: when the batch
size or candidate model changes, SMLT re-runs the Bayesian optimizer and
redeploys; the fixed-allocation baseline (LambdaML-style) cannot.

Run:  PYTHONPATH=src python -m repro_torch.examples.nas_dynamic
"""
from repro_torch.core.constraints import Goal
from repro_torch.core.scheduler import EpochPlan
from repro_torch.optim.schedules import doubling_batch
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


def timeline(res, label):
    print(f"\n  {label}:")
    print(f"  {'t(s)':>8s} {'batch':>6s} {'params':>8s} {'workers':>7s} "
          f"{'mem(MB)':>8s} {'samples/s':>10s}")
    for e in res.events:
        if e.kind != "epoch":
            continue
        print(f"  {e.t:8.0f} {e.batch_size:6d} "
              f"{e.model_params/1e6:7.0f}M {e.workers:7d} "
              f"{e.memory_mb:8d} {e.throughput:10.1f}")
    print(f"  -> wall {res.wall_s:,.0f}s, total ${res.total_cost:.2f}")


def main():
    """Returns the three runs (adaptive, fixed, NAS)."""
    w = WORKLOADS["resnet50"]
    print("== dynamic batching (batch doubles every 2 epochs) ==")
    batches = doubling_batch(256, 6, every=2)
    plans = [EpochPlan(b, w, samples=50_000) for b in batches]
    sched, *_ = fresh_scheduler("hier", seed=0)
    adaptive = sched.run(plans, Goal("min_time"))
    timeline(adaptive, "SMLT (adaptive)")
    sched, *_ = fresh_scheduler("hier", seed=0)
    fixed = sched.run(plans, Goal("min_time"), adaptive=False,
                      fixed_config=adaptive.config_history[0])
    timeline(fixed, "fixed allocation (LambdaML-style)")

    print("\n== NAS / ENAS exploration (12 candidate child models) ==")
    import numpy as np
    from repro_torch.serverless import Workload
    rng = np.random.RandomState(0)  # simlint: ok(det-raw-randomstate, the reference example's own numpy draw; it must stay bit-equal)
    sizes = rng.choice([5e6, 11e6, 23e6, 46e6, 80e6, 110e6], size=12)
    tokens = rng.choice([64, 256, 1024], size=12)
    cands = [Workload(f"enas-{i}", int(s), 6.0 * s * t, 3_000, 10 ** 9)
             for i, (s, t) in enumerate(zip(sizes, tokens))]
    plans = [EpochPlan(512, c, samples=50_000) for c in cands]
    sched, *_ = fresh_scheduler("hier", seed=0)
    nas = sched.run(plans, Goal("min_time"))
    timeline(nas, "SMLT (adaptive)")
    return adaptive, fixed, nas


if __name__ == "__main__":
    main()
