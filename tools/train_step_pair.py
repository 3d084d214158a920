#!/usr/bin/env python3
"""The training steps of chip_smoke.py's phases 5, 17 and 29 for one or
more checkouts of the repo, one after the other on the same NVIDIA GPU, so
that two versions are compared on one card in one run.

    python3 tools/train_step_pair.py ROOT [ROOT ...]

For each ROOT in the order given (list one twice to interleave: parent,
change, change, parent), a child process imports that checkout's
chip_smoke.py and package, builds its kernels into its own build/, and
runs full-width olmo-1b in bf16 at batch 8 x 2048 with the flash kernel:
  pool    phase 5: the Fig. 5 LocalWorkerPool step (4 workers), 3 steps;
  hier    phase 17: launch/train.py::train with the hier step, 5 steps;
  zero3   phase 29: the same with ZeRO-3 parameters (fsdp=True).
Each prints one JSON line: step seconds (host clock around the step, up to
torch.cuda.synchronize()), the median of the steps after the first, the
peak device memory (max_memory_allocated, reset before the phase),
the losses and the kernels' launch counts. The parent process prints the
card's name and power limit first and a summary table last. Exits
non-zero without a CUDA device or when a child fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path


def one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as c
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    device = torch.device("cuda", 0)
    cfg = ARCHS["olmo-1b"].replace(use_flash_kernel=True)
    out = {"root": str(root)}
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, launches = c.run_main_path(cfg, device, c.GLOBAL_BATCH,
                                               c.SEQ, c.STEPS)
    out["pool"] = dict(step_s=step_s, losses=losses, launches=launches,
                       peak=torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    for name, fsdp in (("hier", False), ("zero3", True)):
        losses, step_s, launches, _, peak = c.run_hier_training(
            cfg, device, c.GLOBAL_BATCH, c.SEQ, c.TRAIN_STEPS, fsdp=fsdp)
        out[name] = dict(step_s=step_s, losses=losses, launches=launches,
                         peak=peak)
    for name in ("pool", "hier", "zero3"):
        out[name]["median_s"] = statistics.median(out[name]["step_s"][1:])
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for root in argv:
        p = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            print(p.stdout[-4000:])
            return p.returncode
        rows.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(f"| root | pool s | pool GiB | hier s | hier GiB | zero3 s | "
          f"zero3 GiB |  ({card})")
    for r in rows:
        print("| " + r["root"] + " | " + " | ".join(
            f"{r[k]['median_s']!r} | {r[k]['peak'] / 2**30:.2f}"
            for k in ("pool", "hier", "zero3")) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
