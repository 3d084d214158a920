"""One run of one cell: set-up, the measured window, the trace, the
per-layer readers and the comparison that decides ``correct``.

Cells, configurations, traffic mixes, metrics and limits are found by the
names in ``BENCHMARK.json`` (see the package docstring); nothing here
names one of them.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from perfbench import trace as tr

JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic mix file
    limits: dict          # {number compared: limit}


def find_cell(root: Path, bench: dict, name: str) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    base = root / "perfbench"
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((base / "limits" / f"{name}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic, limits)


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def metric_file(root: Path, name: str) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or,
    where there is none, the one its kinds share, ``metrics/<the name up
    to its first dot>.py`` (``mfu.train`` and ``mfu.score`` read
    ``mfu.py``)."""
    d = root / "perfbench" / "metrics"
    own = d / f"{name}.py"
    return own if own.is_file() else d / f"{name.split('.')[0]}.py"


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_config(config: dict):
    """The program's ModelConfig for a configuration file's "model"."""
    import torch
    from repro_torch.models.base import ModelConfig
    kw = dict(config["model"])
    kw["dtype"] = getattr(torch, kw["dtype"])
    return ModelConfig(arch_id=config["name"], source=config["source"], **kw)


class Spans:
    """Host-clock spans the loops record around calls into the program's
    layers. Only in a traced run: each span synchronises the device at
    both ends, which an untraced run must not pay."""

    def __init__(self, on: bool, sync):
        self.on, self.sync, self.seconds = on, sync, {}

    def __call__(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        if self.spans.on:
            self.spans.sync()
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.spans.on and exc[0] is None:
            self.spans.sync()
            self.spans.seconds.setdefault(self.name, []).append(
                time.perf_counter() - self.t0)


@dataclasses.dataclass
class Context:
    """What a loop is given: the cell, the run's seed, the device, the
    program's configuration, the reference family and the spans."""
    cell: Cell
    seed: int
    device: object
    cfg: object
    reference: object
    spans: Spans


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads: the cell's files, the window's
    length, the loop's counters, the spans and the trace summary (None
    where nothing was traced)."""
    cell: str
    config: dict
    traffic: dict
    window_s: float
    counters: dict
    spans: dict
    trace: dict

    @property
    def model(self) -> dict:
        return self.config["model"]


def jax_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & JAX_NAMES)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, variant=None) -> dict:
    """The result line of one run of ``workload`` on ``device``, set-up
    counted from ``t_start`` (``time.perf_counter``). With ``variant`` the
    numbers compared are the control's (``loop.control``: the reference
    in a lower precision, or with a planted fault, in the program's
    place), which have to come out not correct."""
    import torch
    bench = load_benchmark(root)
    cell = find_cell(root, bench, workload)
    reference = importlib.import_module(
        f"perfbench.reference.{cell.config['reference']}")
    loop_mod = importlib.import_module(
        f"perfbench.loops.{cell.traffic['loop']}")
    from perfbench.reference import common
    common.no_tf32()
    cfg = model_config(cell.config)
    is_cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if is_cuda else (
        lambda: None)
    spans = Spans(False, sync)          # on in a traced run's window only
    ctx = Context(cell, seed, device, cfg, reference, spans)
    if is_cuda:
        torch.zeros(1, device=device)        # the CUDA context, before the
        torch.cuda.reset_peak_memory_stats(device)      # allocator's stats
    loop = loop_mod.Loop(ctx)
    sync()
    setup_s = time.perf_counter() - t_start

    units = 0
    spans.on = trace
    t0 = time.perf_counter()
    while True:
        loop.step(units)
        units += 1
        if time.perf_counter() - t0 >= seconds and loop.boundary(units):
            break
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    counters, attempted = loop.counters(), loop.attempted()
    e2e = loop.window_metrics(window_s, units)
    e2e["setup_s"] = setup_s
    spans.on = False        # the traced units after the window are not spans
    summary = (tr.trace_units(loop, units, int(cell.traffic["trace_steps"]),
                              sync) if trace else None)

    run = Run(cell.name, cell.config, cell.traffic, window_s, counters,
              spans.seconds, summary)
    metrics = {}
    for m in metrics_of(bench, cell.name, trace):
        if trace:
            reader = load_file(metric_file(root, m["name"]),
                               f"perfbench_metric_{len(metrics)}")
            value = reader.read(run)
        else:
            value = e2e.get(m["name"])
            if value is None:
                raise RuntimeError(f"{cell.name} reports no {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    failed = 0
    outputs = loop.outputs()
    loop.release()
    del loop
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    readings = (loop_mod.check(ctx, outputs) if variant is None
                else loop_mod.control(ctx, outputs, variant))
    if set(readings) != set(cell.limits):
        raise RuntimeError(f"{cell.name} compares {sorted(readings)}, its "
                           f"limits name {sorted(cell.limits)}")
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in readings.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if is_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if is_cuda
           else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = tr.breakdown(summary)
    out["checks"] = checks
    return out
