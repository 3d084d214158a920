#!/usr/bin/env python3
"""Readings that set a cell's limits, in one process on the card:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--variants fp8,half --variant-seeds 7,8,9] [--seconds 3] \
        [--out calibrate.jsonl]

For each of ``--seeds`` one run of the program with a short window, for
each variant and each of ``--variant-seeds`` one run of the control
(``harness.run_cell(..., variant=...)``). Prints, and appends to
``--out``, one JSON line a run: the numbers compared, ``correct``, the
end-to-end metrics and the peak. ``run.py`` never calls this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as _run  # noqa: E402,F401  (the caches and paths of a run)

ROOT = _run.ROOT


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--variants", default="")
    ap.add_argument("--variant-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    jobs = [(s, None) for s in ints(args.seeds)] + [
        (s, v) for v in args.variants.split(",") if v
        for s in ints(args.variant_seeds)]
    failed = 0
    for seed, variant in jobs:
        t = time.perf_counter()
        try:
            r = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                                 False, dev, t, variant=variant)
        except Exception:                   # one bad seed; go on
            traceback.print_exc()
            failed += 1
            continue
        line = {"workload": args.workload, "seed": seed, "variant": variant,
                "correct": r["correct"],
                "checks": {k: v["value"] for k, v in r["checks"].items()},
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "peak": r["device"]["memory_peak_bytes"],
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(ROOT / args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    print(f"calibrate.py: {len(jobs) - failed} runs, {failed} failed, "
          f"{time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
