#!/usr/bin/env python3
"""Where one step of the port's main path spends its time, on one NVIDIA
GPU.

    python3 tools/profile_main_path.py

Builds the kernels, sets up chip_smoke.py's main path (full-width olmo-1b,
bf16, flash kernel, LocalWorkerPool n=4 scatter_reduce bsp with the
aggregation kernel, AdamW, batch 8 x 2048), runs one warm-up step, then:
  - times each phase of a step with the host clock around
    torch.cuda.synchronize(): the 4 workers' forward + backward, the rest
    of the pool step (flatten, shard, aggregate, join, unflatten), the
    AdamW update;
  - traces one step with torch.profiler and sums device time by kernel
    and by kernel family; the idle share is 1 - device busy / step wall
    (the wall includes the profiler's host overhead and the data loader,
    so it is an upper bound; the phase times are the cleaner split).
Prints the card's name and power limit first. Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import collections
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FAMILIES = [  # first match wins
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
    import torch
    if not torch.cuda.is_available():
        print("profile_main_path: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.core import tree as T
    from repro_torch.kernels import _build
    from repro_torch.models import registry
    from repro_torch.optim import AdamW, warmup_cosine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), "|", torch.__version__, torch.version.cuda,
          flush=True)
    _build.load()
    device = torch.device("cuda", 0)
    cfg = ARCHS["olmo-1b"].replace(use_flash_kernel=True)
    params = registry.init(0, cfg, device)
    opt = AdamW(lr=3e-4, schedule=warmup_cosine(2, 10))
    state = opt.init(params)
    phase = collections.Counter()

    def timed(name, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        phase[name] += time.perf_counter() - t0
        return out

    grad = T.grad(lambda p, b: registry.loss_fn(p, cfg, b))
    pool = cs.pool_for(cfg, use_kernel=True)
    pool.grad_fn = lambda p, b: timed("workers' forward + backward", grad,
                                      p, b)
    loader = cs.make_loader(cfg, cs.SEQ)

    def step(params, state):
        batch = T.from_numpy(loader.next_batch(cs.GLOBAL_BATCH), device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = pool.step(params, batch)
        torch.cuda.synchronize()
        phase["pool step total"] += time.perf_counter() - t0
        params, state = timed("AdamW update", opt.update, g, state, params)
        return params, state

    params, state = step(params, state)                       # warm-up
    phase.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        params, state = step(params, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0      # before the trace is processed

    pool_rest = phase["pool step total"] - phase["workers' forward + backward"]
    print(f"step wall {wall:.4f} s (profiler on):")
    for name in ("workers' forward + backward", "AdamW update"):
        print(f"  {name:32s} {phase[name]:.4f} s")
    print(f"  {'shard/aggregate/join/unflatten':32s} {pool_rest:.4f} s")

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
