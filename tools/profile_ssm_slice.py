#!/usr/bin/env python3
"""Where the time of a served model goes, on one NVIDIA GPU: a full-width
model (bf16, random weights from seed 0, its kernels on) scored and served
as chip_smoke.py does it.

    python3 tools/profile_ssm_slice.py [--arch mamba2-2.7b|zamba2-7b|
        qwen2-moe-a2.7b|seamless-m4t-medium|llama-3.2-vision-90b]

  - mamba2-2.7b (the default; phase 9): the SSD kernel, scoring on
    8 x 2048 tokens, prefill of 4 prompts of 2048 tokens;
  - zamba2-7b (phase 13): the SSD and flash kernels, scoring on 4 x 4096,
    prefill of 4 prompts of 4096 (which runs the flash kernel at its 13
    shared-block sites);
  - qwen2-moe-a2.7b (phase 14): the flash kernel, scoring on 8 x 2048,
    prefill of 4 prompts of 2048;
  - seamless-m4t-medium (phase 21): the flash kernel in the decoder,
    scoring on 8 x 2048 with 512 audio frames, prefill of 4 prompts of
    2048 with 1024 frames;
  - llama-3.2-vision-90b cut to 20 layers (phase 21): the flash kernel in
    the self layers, scoring on 4 x 2048 with 1600 image tokens, prefill
    of 4 prompts of 2048 with 1600 image tokens.
Scoring takes chip_smoke.modality_inputs (random, at batch_extras'
shapes, as phase 21 scores); prefill and decode take the engine's zero
stubs (serving.engine.modality_stubs: cfg.n_audio_frames frames for
audio), as phase 21 serves.

Builds the kernels, then traces with torch.profiler, after one untraced
warm-up of each:
  - one scoring evaluation (registry.loss_fn);
  - one prefill (plain chunked SSD from a zero cache, for the SSM layers);
  - 8 decode steps of that batch.
For each it prints the wall time without the profiler (host clock up to
torch.cuda.synchronize) and with it (an upper bound: the profiler's own
host work), device busy time, the idle share 1 - busy / untraced wall,
the number of kernels launched, device time by kernel family (the
families of tools/profile_main_path.py) and the kernels that take the
most of it. A throwaway trace first starts
the profiler, so its start-up lands in no region. Prints the card's name
and power limit first. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402  (imports no torch at module level)

DECODE_STEPS = 8
TOP_KERNELS = 6  # kernels listed by name under each region's families
# arch -> (its kernel flags and cuts, scoring batch x seq, prefill prompts
# x length): chip_smoke.py's phases 9, 13, 14 and 21
CELLS = {
    "mamba2-2.7b": (dict(use_ssd_kernel=True), (cs.GLOBAL_BATCH, cs.SEQ),
                    (cs.SERVE_REQUESTS, cs.SEQ)),
    "zamba2-7b": (dict(use_flash_kernel=True, use_ssd_kernel=True),
                  (cs.HYBRID_BATCH, cs.HYBRID_SEQ),
                  (cs.SERVE_REQUESTS, cs.HYBRID_SEQ)),
    "qwen2-moe-a2.7b": (dict(use_flash_kernel=True),
                        (cs.GLOBAL_BATCH, cs.SEQ),
                        (cs.SERVE_REQUESTS, cs.SEQ)),
    "seamless-m4t-medium": (dict(use_flash_kernel=True),
                            (cs.GLOBAL_BATCH, cs.SEQ),
                            (cs.SERVE_REQUESTS, cs.SEQ)),
    "llama-3.2-vision-90b": (dict(use_flash_kernel=True,
                                  n_layers=cs.VISION_DEPTH),
                             (cs.VISION_BATCH, cs.SEQ),
                             (cs.SERVE_REQUESTS, cs.SEQ)),
}


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


def untraced(fn, runs: int = 1):
    """(the last result, host seconds a run up to a device synchronise)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / runs


def report(name, wall, traced_wall, kernels, counts, per=1):
    """``wall``: untraced seconds a run; the rest summed over ``per``."""
    from profile_main_path import family
    busy = sum(kernels.values()) / per
    n = sum(counts.values())
    print(f"{name}: wall {wall:.4f} s (traced {traced_wall / per:.4f} s), "
          f"device busy {busy:.4f} s, idle share {1 - busy / wall:.3f}, "
          f"{n / per:.0f} kernels"
          + (f" (per step, {per} steps)" if per > 1 else ""))
    fams = collections.Counter()
    for k, s in kernels.items():
        fams[family(k)] += s
    for fam, s in fams.most_common():
        print(f"  {fam:28s} {s / per:.4f} s  {s / per / busy:.3f}")
    for k, s in kernels.most_common(TOP_KERNELS):
        print(f"    {s / per:.4f} s  {counts[k] / per:6.0f} x  {k[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b", choices=sorted(CELLS))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_ssm_slice: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS
    from repro_torch.core import tree as T
    from repro_torch.kernels import _build
    from repro_torch.models import registry
    from repro_torch.serving.engine import modality_stubs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), "|", torch.__version__, torch.version.cuda,
          flush=True)
    _build.load()
    device = torch.device("cuda", 0)
    flags, (sb, ss), (pb, ps) = CELLS[args.arch]
    cfg = ARCHS[args.arch].replace(**flags)
    print(f"{cfg.arch_id}: scoring {sb} x {ss}, prefill {pb} x {ps}, "
          f"{DECODE_STEPS} decode steps; {flags}", flush=True)
    params = registry.init(0, cfg, device)
    loader = cs.make_loader(cfg, ss)
    batch = T.from_numpy(loader.next_batch(sb), device)
    batch.update(cs.modality_inputs(cfg, sb, ss, device))
    rng = np.random.RandomState(0)
    prompts = {"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (pb, ps)).astype(np.int32)).to(device),
        **modality_stubs(cfg, pb, device)}

    with torch.no_grad():
        def score():
            return registry.loss_fn(params, cfg, batch)

        def prefill():
            return registry.prefill(params, cfg, prompts,
                                    max_seq=ps + 2 * DECODE_STEPS + 2)

        trace(lambda: torch.ones(1, device=device) + 1)  # profiler start-up
        score()                                                # warm-up
        _, wall = untraced(score)
        _, traced_wall, k, c = trace(score)
        report(f"scoring evaluation ({sb} x {ss})", wall, traced_wall, k, c)
        logits, cache = prefill()                              # warm-up
        del logits, cache
        (logits, cache), wall = untraced(prefill)
        del logits, cache
        (logits, cache), traced_wall, k, c = trace(prefill)
        report(f"prefill ({pb} x {ps})", wall, traced_wall, k, c)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        del logits
        state = {"cache": cache, "tok": tok, "pos": ps}

        def decode(steps):
            for _ in range(steps):
                logits, state["cache"] = registry.decode_step(
                    params, cfg, state["cache"], state["pos"], state["tok"])
                state["tok"] = torch.argmax(logits[:, :, :cfg.vocab_size],
                                            dim=-1)
                state["pos"] += 1

        decode(2)                                              # warm-up
        _, wall = untraced(lambda: decode(1), runs=DECODE_STEPS)
        _, traced_wall, k, c = trace(lambda: decode(DECODE_STEPS))
        report("decode", wall, traced_wall, k, c, per=DECODE_STEPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
