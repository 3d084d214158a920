"""Quickstart: the three layers of SMLT in one minute (the port's
counterpart of the JAX package's ``examples/quickstart.py``).

  1. the REAL training path — hierarchical sync on a model from the zoo;
  2. the SCHEDULER — user-centric deadline goal on the serverless simulator;
  3. the KERNELS — the CUDA shard aggregation vs its plain version.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the CUDA card unless ``--device`` says otherwise; on a CPU tensor
layer 3's kernel wrapper runs its plain version.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.constraints import Goal
from repro_torch.core.scheduler import EpochPlan
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import train
from repro_torch.models import registry
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


def real_training(device):
    """1. real training: reduced olmo-1b, hierarchical (RS+AG) gradient
    sync; returns the losses."""
    cfg = reduced(ARCHS["olmo-1b"])
    print(f"[1/3] training reduced {cfg.arch_id} "
          f"({registry.param_count(cfg)/1e6:.1f}M params) on {device}")
    _, losses, _ = train(cfg, steps=40, batch=8, seq=64, strategy="hier",
                         lr=1e-3, log_every=20, device=device)
    assert losses[-1] < losses[0]
    return losses


def scheduler_scenario():
    """2. scheduler: minimize cost under a 1-hour deadline (paper
    Scenario 1); returns the ``RunResult``."""
    print("[2/3] SMLT scheduler, Scenario 1 (min cost s.t. T <= 1h)")
    sched, *_ = fresh_scheduler("hier")
    res = sched.run([EpochPlan(1024, WORKLOADS["bert-small"], samples=30_000)
                     for _ in range(3)],
                    Goal("min_cost_deadline", deadline_s=3600.0),
                    stop_at_deadline=True)
    cfgs = {(c.workers, c.memory_mb) for c in res.config_history}
    print(f"      deployed {cfgs}; wall {res.wall_s:.0f}s <= 3600s; "
          f"cost ${res.total_cost:.2f} (profiling ${res.profile_usd:.2f})")
    assert cfgs and res.wall_s <= 3600.0
    return res


def kernel_check(device):
    """3. the shard-aggregation kernel == its plain version; returns the
    largest absolute difference."""
    print("[3/3] hier_agg kernel vs plain torch version")
    shards = torch.tensor(np.random.RandomState(0).randn(8, 4096),  # simlint: ok(det-raw-randomstate, the reference quickstart's own numpy draw; it must stay bit-equal)
                          dtype=torch.float32, device=device)
    got, want = ops.aggregate_shards(shards), ref.ref_aggregate(shards)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    print("      allclose OK")
    return float((got - want).abs().max())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    losses = real_training(device)
    res = scheduler_scenario()
    err = kernel_check(device)
    print("quickstart done.")
    return losses, res, err


if __name__ == "__main__":
    main()
