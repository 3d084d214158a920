#!/usr/bin/env python3
"""Where the time of the second slice goes, on one NVIDIA GPU: full-width
mamba2-2.7b (bf16, random weights from seed 0) scored and served as
chip_smoke.py phase 9 does.

    python3 tools/profile_ssm_slice.py

Builds the kernels, then traces with torch.profiler, after one untraced
warm-up of each:
  - one scoring evaluation (registry.loss_fn through the SSD kernel,
    8 x 2048 tokens);
  - one prefill of 4 prompts of 2048 tokens (plain chunked SSD);
  - 8 decode steps of that batch.
For each it prints the wall time (host clock up to torch.cuda.synchronize,
profiler on, so an upper bound), device busy time, the idle share
1 - busy / wall, the number of kernels launched, and device time by kernel
family (the families of tools/profile_main_path.py). Prints the card's
name and power limit first. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

DECODE_STEPS = 8


def trace(fn):
    """Run ``fn`` under the profiler; returns (its result, wall s, device
    s by kernel name, launches by kernel name)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0      # before the trace is processed
    kernels, counts = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] += us / 1e6
        counts[e.key] += e.count
    return out, wall, kernels, counts


def report(name, wall, kernels, counts, per=1):
    from profile_main_path import family
    busy = sum(kernels.values())
    n = sum(counts.values())
    print(f"{name}: wall {wall / per:.4f} s, device busy {busy / per:.4f} s, "
          f"idle share {1 - busy / wall:.3f}, {n / per:.0f} kernels"
          + (f" (per step, {per} steps)" if per > 1 else ""))
    fams = collections.Counter()
    for k, s in kernels.items():
        fams[family(k)] += s
    for fam, s in fams.most_common():
        print(f"  {fam:28s} {s / per:.4f} s  {s / busy:.3f}")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_ssm_slice: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.core import tree as T
    from repro_torch.kernels import _build
    from repro_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), "|", torch.__version__, torch.version.cuda,
          flush=True)
    _build.load()
    device = torch.device("cuda", 0)
    cfg = ARCHS["mamba2-2.7b"].replace(use_ssd_kernel=True)
    params = registry.init(0, cfg, device)
    loader = cs.make_loader(cfg, cs.SEQ)
    batch = T.from_numpy(loader.next_batch(cs.GLOBAL_BATCH), device)
    rng = np.random.RandomState(0)
    prompts = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (cs.SERVE_REQUESTS, cs.SEQ)).astype(np.int32)
    ).to(device)

    with torch.no_grad():
        def score():
            return registry.loss_fn(params, cfg, batch)

        def prefill():
            return registry.prefill(params, cfg, {"tokens": prompts})

        score()                                                # warm-up
        _, wall, k, c = trace(score)
        report("scoring evaluation (8 x 2048)", wall, k, c)
        logits, cache = prefill()                              # warm-up
        del logits, cache
        (logits, cache), wall, k, c = trace(prefill)
        report("prefill (4 x 2048)", wall, k, c)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        del logits
        state = {"cache": cache, "tok": tok, "pos": cs.SEQ}

        def decode(steps):
            for _ in range(steps):
                logits, state["cache"] = registry.decode_step(
                    params, cfg, state["cache"], state["pos"], state["tok"])
                state["tok"] = torch.argmax(logits[:, :, :cfg.vocab_size],
                                            dim=-1)
                state["pos"] += 1

        decode(2)                                              # warm-up
        _, wall, k, c = trace(lambda: decode(DECODE_STEPS))
        report("decode", wall, k, c, per=DECODE_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(DECODE_STEPS)
        torch.cuda.synchronize()
        print(f"decode without the profiler: "
              f"{(time.perf_counter() - t0) / DECODE_STEPS:.4f} s a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
