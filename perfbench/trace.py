"""A summary of a short ``torch.profiler`` trace of the window: the
device time of each kernel, the union of the device's busy intervals, and
the idle gaps between them by the host operation that ran meanwhile. Only
the summary is kept; no trace is written."""
from __future__ import annotations

import bisect
import collections
import re

from perfbench import yardstick

WINDOW = "perfbench.traced"          # the host range around the traced steps
MAX_GAPS = 1_000_000                 # the longest gaps that get a host name


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns) of every event of the trace."""
    out = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no trace")
    for e in results.events():
        act = str(getattr(e, "activity_type", lambda: "")()).lower()
        dev = str(e.device_type()).split(".")[-1] != "CPU"
        if dev and ("annotation" in act or e.name() == WINDOW):
            continue
        out.append((e.name(), dev, e.start_ns(), e.end_ns()))
    return out


def summarize(prof, steps: int) -> dict:
    """The trace of ``steps`` units of work inside the host range
    ``WINDOW`` -> {"window_s", "busy_s", "steps", "kernels": {name:
    [seconds, count]}, "gaps": {host op: seconds}}."""
    events = _raw_events(prof)
    win = [e for e in events if not e[1] and e[0] == WINDOW]
    if not win:
        raise RuntimeError(f"no {WINDOW!r} range in the trace")
    w0, w1 = win[0][2], win[0][3]
    kernels = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for name, dev, a, b in events:
        if not dev or b <= w0 or a >= w1:
            continue
        a, b = max(a, w0), min(b, w1)
        kernels[name][0] += (b - a) / 1e9
        kernels[name][1] += 1
        spans.append((a, b))
    spans.sort()
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e9
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    host = sorted((a, b, name) for name, dev, a, b in events
                  if not dev and name != WINDOW
                  and not name.startswith("ProfilerStep"))
    starts = [h[0] for h in host]
    by_op = collections.Counter()
    for length, at in gaps[:MAX_GAPS]:
        by_op[_host_op(host, starts, at)] += length / 1e9
    rest = sum(length for length, _ in gaps[MAX_GAPS:]) / 1e9
    if rest:
        by_op["(shorter gaps)"] += rest
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy, "steps": steps,
            "kernels": {k: v for k, v in kernels.items()},
            "gaps": dict(by_op)}


def _host_op(host, starts, at) -> str:
    """The innermost host op running at ``at`` (the latest to start among
    those that cover it)."""
    i = bisect.bisect_right(starts, at) - 1
    for j in range(i, max(i - 400, -1), -1):
        a, b, name = host[j]
        if b > at:
            return name
    return "(host between ops)"


def family_seconds(summary: dict) -> dict:
    fams = collections.Counter()
    for name, (sec, _) in summary["kernels"].items():
        fams[yardstick.family(name)] += sec
    return dict(fams)


def kernel_seconds(summary: dict, pattern: str) -> float:
    return sum(sec for name, (sec, _) in summary["kernels"].items()
               if re.search(pattern, name))


def breakdown(summary: dict) -> dict:
    ops = sorted(((k, v[0]) for k, v in summary["kernels"].items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k[:120], v] for k, v in gaps]}


def trace_units(loop, start: int, steps: int, sync) -> dict:
    """Run units ``start .. start + steps`` of ``loop`` under the profiler
    and summarise units ``start + 1 ..``: the first is profiled and thrown
    away (the profiler's first cycle)."""
    import time
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts):
        loop.step(start)
        sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for j in range(1, steps + 1):
                loop.step(start + j)
            sync()
    t0 = time.perf_counter()
    out = summarize(prof, steps)
    out["summary_s"] = time.perf_counter() - t0
    return out
