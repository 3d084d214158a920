"""Training launcher (port of the JAX package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --reduced --steps 50 --batch 8 --seq 128 [--device cpu]

trains with the ``hier`` step (``--strategy hier|hier1|allreduce``, see
``launch/steps.py``) on every rank of the process group, one rank when
none is initialised. Runs on the CUDA card unless ``--device`` says
otherwise. (The reference's ``--dry-run`` lowering check waits for the
dry-run tools, ROADMAP A16.)
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, reduced
from repro_torch.core import tree as T
from repro_torch.data import DataConfig, ShardedLoader, TokenDataset
from repro_torch.launch.mesh import make_custom_mesh, process_group
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry
from repro_torch.optim import AdamW, warmup_cosine


def make_local_mesh(device="cuda"):
    """Every rank of the process group on the data axis, model 1."""
    dev = torch.device(device)
    return make_custom_mesh(f"{dist.get_world_size()}x1", dev.type)


def train(cfg, *, steps: int, batch: int, seq: int, strategy: str,
          lr: float = 3e-4, log_every: int = 10, loader=None, params=None,
          device="cuda"):
    """Train ``cfg`` for ``steps`` steps of a global batch of ``batch`` x
    ``seq`` tokens, each rank of the process group on its rows (a one-rank
    group is made, and destroyed on return, when none is initialised).
    ``params`` (e.g. the reference's, carried across) replaces the
    seed-0 init. Returns (params, losses, step seconds), each step timed
    on the host clock up to its loss read back."""
    dev = T.resolve_device(device)
    with process_group(dev):
        mesh = make_local_mesh(dev)
        opt = AdamW(lr=lr, schedule=warmup_cosine(max(steps // 20, 1), steps))
        step_fn = make_train_step(cfg, mesh, strategy=strategy, optimizer=opt)
        if params is None:
            params = registry.init(0, cfg, dev)
        opt_state = step_fn.init_opt_state(params)

        loader = loader or ShardedLoader(TokenDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq)))
        losses, step_s = [], []
        t0 = time.perf_counter()
        for i in range(steps):
            b = T.from_numpy(step_fn.local_batch(loader.next_batch(batch)),
                             dev)
            t = time.perf_counter()
            params, opt_state, loss = step_fn(params, opt_state, b)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t)
            if dist.get_rank() == 0 and (i % log_every == 0
                                         or i == steps - 1):
                dt = time.perf_counter() - t0
                tput = (i + 1) * batch * seq / dt
                print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                      f"{tput:,.0f} tok/s", flush=True)
    return params, losses, step_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--strategy", default="hier",
                    choices=["hier", "hier1", "allreduce"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    _, losses, _ = train(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, strategy=args.strategy, lr=args.lr,
                         device=args.device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
