#!/usr/bin/env python3
"""Events/s of the port's event engine beside the JAX package's, in one
process, on the ``benchmarks/engine_throughput.py --quick`` scenarios.

    PYTHONPATH=src python tools/engine_throughput_pair.py \
        [--out experiments/engine_pair.json]

The benchmark's own scenario functions run twice, once bound to each
package: its module is loaded a second time with its ``repro.serverless``
and ``repro.serving`` imports pointed at ``repro_torch``. Each round runs
reference, port, port, reference (interleaved, so host drift hits both),
each row the best of the benchmark's ``REPEATS`` runs; a row's events/s
is its best over ``ROUNDS`` rounds. The reference side needs ``jax``
(its package init imports it); where jax is missing the port runs alone.
The last line is one JSON object: ratios port / reference, host.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import platform
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
BENCH = ROOT / "benchmarks" / "engine_throughput.py"
ROUNDS = 2


def load(side: str):
    """``benchmarks/engine_throughput.py`` bound to one package."""
    src = BENCH.read_text()
    if side == "port":
        for mod in ("serverless", "serving"):
            old = f"from repro.{mod} import"
            if old not in src:
                raise RuntimeError(f"{BENCH} no longer imports {old!r}")
            src = src.replace(old, f"from repro_torch.{mod} import")
    spec = importlib.util.spec_from_loader(f"engine_throughput_{side}",
                                           loader=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__file__ = str(BENCH)
    exec(compile(src, str(BENCH), "exec"), mod.__dict__)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sides = ["ref", "port"] if importlib.util.find_spec("jax") else ["port"]
    mods = {s: load(s) for s in sides}
    order = sides + sides[::-1]
    best = {s: {} for s in sides}
    for _ in range(ROUNDS):
        for side in order:
            for r in mods[side].full_grid(True):
                prev = best[side].get(r["key"])
                if prev is None or r["events_per_s"] > prev["events_per_s"]:
                    best[side][r["key"]] = r
    keys = list(best[sides[0]])
    print(f"{'key':>18} " + " ".join(f"{s + ' ev/s':>14}" for s in sides)
          + ("   port/ref" if len(sides) == 2 else ""))
    ratios = {}
    for k in keys:
        vals = [best[s][k]["events_per_s"] for s in sides]
        line = f"{k:>18} " + " ".join(f"{v:>14.1f}" for v in vals)
        if set(sides) == {"ref", "port"}:
            ratios[k] = best["port"][k]["events_per_s"] / \
                best["ref"][k]["events_per_s"]
            line += f"   {ratios[k]:.4f}"
            if best["port"][k]["sim_events"] != best["ref"][k]["sim_events"]:
                raise RuntimeError(f"{k}: the two engines simulated "
                                   "different event counts")
        print(line)
    report = {"rows": best, "port_over_ref": ratios,
              "host": {"machine": platform.machine(),
                       "processor": platform.processor(),
                       "cpus": os.cpu_count(),
                       "python": platform.python_version()}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"port_over_ref": ratios, "host": report["host"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
