"""Run the port's dry run over every (arch, shape) pair on both production
meshes, or on the meshes named by ``--mesh-shape``, several pairs at a
time, and print a markdown table of the per-rank terms.

    PYTHONPATH=src python tools/dryrun_table.py --out experiments/dryrun \\
        [--jobs 8] [--device cuda] [--arch ARCH ...] [--shape SHAPE ...] \\
        [--mesh-shape 32x8 --mesh-shape 2x32x8 ...] [--set seq_shard=True]

Each pair is one ``python -m repro_torch.launch.dryrun --arch A --shape S
--both-meshes --out DIR`` process (with ``--mesh-shape``, one process per
pair and mesh); together they are the CLI's ``--all --both-meshes``
(``--arch`` and ``--shape``, repeated, keep only those archs' and
shapes' pairs; ``--set`` passes a config override on, e.g.
``seq_shard=True``, into an ``--out`` of its own). The table reads the
per-pair JSON files. Exits 1, listing them, if any pair failed.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import pairs  # noqa: E402


def run_pair(arch: str, shape: str, out: str, device: str, mesh=None,
             sets=()):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out, "--device", device]
    cmd += ["--mesh-shape", mesh] if mesh else ["--both-meshes"]
    for kv in sets:
        cmd += ["--set", kv]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT)
    name = f"{arch}__{shape}" + (f"__{mesh}" if mesh else "")
    with open(os.path.join(out, f"{name}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    return arch, shape, mesh, proc.returncode


PRODUCTION = ("256x1", "2x256x1")


def table(out: str, meshes=PRODUCTION) -> str:
    """One row per (arch, shape): the per-rank terms on each of
    ``meshes`` in order, one value where they agree, else each (joined
    by "/")."""
    runs = {}
    for path in sorted(glob.glob(os.path.join(out, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r["mesh"] in meshes:
            runs.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def both(rs, fmt):
        vals = [fmt(rs[m]) for m in meshes if m in rs]
        return vals[0] if len(set(vals)) == 1 else " / ".join(vals)

    def mem(key, scale, digits):
        return lambda r: f"{r['memory'][key] / scale:.{digits}f}"
    rows = ["| arch | shape | TFLOP | bytes accessed (GB) | collective (GB) "
            "| arguments (GiB) | peak (GiB) | trace_s |",
            "|---|---|---|---|---|---|---|---|"]
    for (arch, shape), rs in runs.items():
        rows.append("| " + " | ".join([
            arch, shape,
            both(rs, lambda r: f"{r['flops'] / 1e12:.1f}"),
            both(rs, lambda r: f"{r['bytes_accessed'] / 1e9:.1f}"),
            both(rs, lambda r: f"{r['collective_bytes'] / 1e9:.2f}"),
            both(rs, mem("argument_size_in_bytes", 2 ** 30, 2)),
            both(rs, mem("peak_memory_in_bytes", 2 ** 30, 1)),
            " / ".join(str(rs[m].get("trace_s", "-")) for m in meshes
                       if m in rs)]) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", action="append",
                    help="only this arch's pairs (repeatable)")
    ap.add_argument("--shape", action="append",
                    help="only this shape's pairs (repeatable)")
    ap.add_argument("--set", action="append", default=[],
                    help="a config override for every pair, e.g. "
                    "seq_shard=True (repeatable)")
    ap.add_argument("--mesh-shape", action="append",
                    help="a mesh instead of the two production ones, e.g. "
                    "32x8, 2x32x8, 16x16, 2x16x16 (repeatable)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    todo = [(a, s, m) for a, s in pairs()
            if (not args.arch or a in args.arch)
            and (not args.shape or s in args.shape)
            for m in (args.mesh_shape or [None])]
    with ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(lambda p: run_pair(p[0], p[1], args.out,
                                                args.device, p[2], args.set),
                             todo))
    meshes = tuple(args.mesh_shape or PRODUCTION)
    print(table(args.out, meshes))
    failed = [(a, s, m) for a, s, m, rc in done if rc]
    if failed:
        print("FAILURES:", failed)
        raise SystemExit(1)
    print(f"dry run complete: {len(todo) // len(args.mesh_shape or [1])} "
          f"pairs x {len(meshes)} meshes traced")


if __name__ == "__main__":
    main()
