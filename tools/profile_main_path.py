#!/usr/bin/env python3
"""Where one step of the port's main path spends its time, on one NVIDIA
GPU.

    python3 tools/profile_main_path.py [--step pool|hier]

Builds the kernels and sets up full-width olmo-1b, bf16, the flash kernel,
AdamW, batch 8 x 2048, with one of two steps:
  pool  chip_smoke.py's phase 5: LocalWorkerPool n=4 scatter_reduce bsp
        with the aggregation kernel, then AdamW;
  hier  chip_smoke.py's phase 17: launch/steps.py's ``hier`` train step at
        world size 1 (NCCL), as launch/train.py runs it.
It runs one warm-up step, then:
  - times each phase of a step with the host clock around
    torch.cuda.synchronize(), with the peak device memory of each: pool:
    the 4 workers' forward + backward, the rest of the pool step
    (flatten, shard, aggregate, join, unflatten), the AdamW update; hier:
    the whole step, its AdamW update on the shards, and (timed apart,
    outside the traced step, on a batch of the same shape) the forward +
    backward it starts with; the rest is the reduce-scatter, all-gather
    and their copies;
  - traces one step with torch.profiler and sums device time by kernel
    and by kernel family; the idle share is 1 - device busy / step wall
    (the wall includes the profiler's host overhead and the data loader,
    so it is an upper bound; the phase times are the cleaner split).
Prints the card's name and power limit first. Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FAMILIES = [  # first match wins
    ("collective (NCCL)", r"nccl"),
    ("flash kernel (ours)", r"flash_fwd"),    # either route's kernel
    ("SSD kernel (ours)", r"ssd_scan(_wgmma)?_kernel"),  # either route
    ("aggregation kernel (ours)", r"agg_kernel"),
    ("matmul bf16 (cuBLAS)", r"nvjet|bf16|h_bz"),
    ("matmul f32 (CUDA cores)", r"f32f32|sgemm"),
    ("matmul other", r"gemm|xmma|cutlass|cublas"),
    ("reduction", r"reduce|Reduce"),
    ("softmax / logsumexp", r"softmax|logsumexp|LogSumExp"),
    ("scan (cumsum)", r"scan"),
    ("copy / cast / cat", r"copy|Copy|cat|Cat|direct_copy"),
    ("index / gather / scatter", r"index|Index|gather|scatter|embedding"),
    ("elementwise", r"elementwise|vectorized|Elementwise|unrolled"),
]


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--step", choices=["pool", "hier"], default="pool")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_main_path: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import process_group
    device = torch.device("cuda", 0)
    with process_group(device):
        return profile(args.step, device)


def profile(which: str, device) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.core import tree as T
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_local_mesh
    from repro_torch.models import registry
    from repro_torch.optim import AdamW, warmup_cosine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), "|", torch.__version__, torch.version.cuda,
          f"| step {which}", flush=True)
    _build.load()
    cfg = ARCHS["olmo-1b"].replace(use_flash_kernel=True)
    params = registry.init(0, cfg, device)
    opt = AdamW(lr=3e-4, schedule=warmup_cosine(2, 10))
    phase = collections.Counter()
    peaks, stack = {}, []          # stack: the peaks of the enclosing calls

    def timed(name, fn, *a, **kw):
        torch.cuda.synchronize()
        if stack:
            stack[-1] = max(stack[-1], torch.cuda.max_memory_allocated())
        stack.append(0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        phase[name] += time.perf_counter() - t0
        peak = max(stack.pop(), torch.cuda.max_memory_allocated())
        peaks[name] = max(peaks.get(name, 0), peak)
        if stack:
            stack[-1] = max(stack[-1], peak)
        return out

    grad = T.grad(lambda p, b: registry.loss_fn(p, cfg, b))
    loader = cs.make_loader(cfg, cs.SEQ)
    if which == "pool":
        state = opt.init(params)
        pool = cs.pool_for(cfg, use_kernel=True)
        pool.grad_fn = lambda p, b: timed("workers' forward + backward",
                                          grad, p, b)
        names = ("workers' forward + backward", "AdamW update")
        rest = ("shard/aggregate/join/unflatten", "pool step total",
                "workers' forward + backward")

        def step(params, state):
            batch = T.from_numpy(loader.next_batch(cs.GLOBAL_BATCH), device)
            g = timed("pool step total", pool.step, params, batch)
            params, state = timed("AdamW update", opt.update, g, state,
                                  params)
            return params, state
    else:
        class TimedAdamW:             # the step's optimizer, timed
            init = opt.init

            def update(self, *a, **kw):
                return timed("AdamW update (shards)", opt.update, *a, **kw)

        train_step = make_train_step(cfg, make_local_mesh(device),
                                     strategy="hier", optimizer=opt)
        train_step.optimizer = TimedAdamW()
        state = train_step.init_opt_state(params)
        names = ("forward + backward (apart)", "AdamW update (shards)",
                 "hier step total")
        rest = ("reduce-scatter/all-gather/copies", "hier step total",
                "forward + backward (apart)")

        def step(params, state):
            batch = T.from_numpy(loader.next_batch(cs.GLOBAL_BATCH), device)
            params, state, _ = timed("hier step total", train_step, params,
                                     state, batch)
            return params, state

    params, state = step(params, state)                       # warm-up
    if which == "hier":     # outside the traced step
        apart = T.from_numpy(cs.make_loader(cfg, cs.SEQ).next_batch(
            cs.GLOBAL_BATCH), device)
        phase.clear()
        timed("forward + backward (apart)", grad, params, apart)
        del apart
        fb = phase["forward + backward (apart)"]
    phase.clear()
    if which == "hier":
        phase["forward + backward (apart)"] = fb
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        params, state = step(params, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0      # before the trace is processed

    print(f"step wall {wall:.4f} s (profiler on):")
    for name in names:
        print(f"  {name:34s} {phase[name]:.4f} s  peak {peaks[name]} bytes "
              f"({peaks[name] / 2**30:.2f} GiB)")
    other = phase[rest[1]] - phase[rest[2]] - (
        phase["AdamW update (shards)"] if which == "hier" else 0.0)
    print(f"  {rest[0]:34s} {other:.4f} s")
    kernels = collections.Counter()
    counts = collections.Counter()
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] += us / 1e6
        counts[e.key] += e.count
    busy = sum(kernels.values())
    print(f"device busy {busy:.4f} s of {wall:.4f} s wall: idle share "
          f"{1 - busy / wall:.3f}")
    fams = collections.Counter()
    for k, s in kernels.items():
        fams[family(k)] += s
    print("by kernel family (device s, share of busy):")
    for fam, s in fams.most_common():
        print(f"  {fam:28s} {s:.4f} s  {s / busy:.3f}")
    print("top kernels:")
    for k, s in kernels.most_common(15):
        print(f"  {s:.4f} s  x{counts[k]}  {k[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
