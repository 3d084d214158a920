"""SLO-aware adaptive batching for serverless inference.

The SMLT authors' companion system (BATCH [17], Ali et al. SC'20) shows
serverless inference wants *adaptive batching*: invoke one function per
batch, choosing (max batch size B, batching timeout tau) to meet a latency
SLO at minimum GB-second cost. This module reproduces that control loop on
our serverless cost substrate:

 - a discrete-event queue simulator (Poisson arrivals, linear-in-batch
   execution model calibrated like Lambda),
 - a policy optimizer: grid/Bayesian search over (B, tau, memory) for
   min cost s.t. p99 latency <= SLO — the serving twin of the paper's
   Scenario 1.

A copy of the JAX package's ``serving/batcher.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.rng import base_stream
from repro_torch.serverless.platform import LAMBDA_GB_SECOND, LAMBDA_PER_REQUEST, fn_gflops


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    max_batch: int
    timeout_s: float
    memory_mb: int


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One launched batch: requests ``[i, j)`` started executing at
    ``start`` and finished at ``done``. ``free`` is when the server came
    free for this batch (the previous batch's ``done``): the launch-wait
    invariant is ``start <= max(arrival[i] + timeout_s, free)``."""
    i: int
    j: int
    free: float
    start: float
    done: float


@dataclasses.dataclass
class ServeStats:
    p50_s: float
    p99_s: float
    cost_per_1k: float
    batches: int
    requests: int
    mean_batch: float
    records: Optional[List[BatchRecord]] = None


def exec_time(flops_per_request: float, batch: int, memory_mb: int,
              init_s: float = 0.15) -> float:
    """Serverless inference execution: fixed init + linear in batch."""
    return init_s + flops_per_request * batch / (fn_gflops(memory_mb) * 1e9)


def simulate(policy: ServePolicy, *, arrival_rate: float,
             flops_per_request: float, horizon_s: float = 600.0,
             seed: int = 0, arrivals: Optional[np.ndarray] = None,
             keep_records: bool = False) -> ServeStats:
    """Single-server batching queue: a batch launches when it reaches
    max_batch, the oldest queued request has waited timeout_s since it
    *arrived* (not since the server came free — a request already past
    its timeout launches the moment the server does), or the arrival
    stream is exhausted (a final partial batch never waits out a timeout
    no future arrival can fill).

    ``arrivals`` overrides the Poisson stream with explicit sorted
    timestamps (used by the event-engine parity test); ``keep_records``
    attaches per-batch :class:`BatchRecord` rows to the returned stats.
    """
    if arrivals is None:
        rng = base_stream(seed)
        n = max(int(arrival_rate * horizon_s), 1)
        arrivals = np.sort(rng.uniform(0.0, horizon_s, size=n))
    latencies: List[float] = []
    records: List[BatchRecord] = []
    gb_s = 0.0
    batches = 0
    i = 0
    t = 0.0
    while i < len(arrivals):
        # the oldest request's timeout clock starts at its arrival; when
        # the server is still busy past that deadline, the batch launches
        # the moment the server frees up
        deadline = arrivals[i] + policy.timeout_s
        launch = max(deadline, t)
        j = i
        while (j < len(arrivals) and j - i < policy.max_batch
               and arrivals[j] <= launch):
            j += 1
        batch = j - i
        if batch == policy.max_batch or j == len(arrivals):
            # full batch — or stream exhausted: nothing can join, go now
            start = max(arrivals[j - 1], t)
        else:
            start = launch
        dt = exec_time(flops_per_request, batch, policy.memory_mb)
        done = start + dt
        for k in range(i, j):
            latencies.append(done - arrivals[k])
        if keep_records:
            records.append(BatchRecord(i=i, j=j, free=t, start=start,
                                       done=done))
        gb_s += policy.memory_mb / 1024.0 * dt
        batches += 1
        t = done
        i = j
    lat = np.array(latencies)
    cost = gb_s * LAMBDA_GB_SECOND + batches * LAMBDA_PER_REQUEST
    return ServeStats(
        p50_s=float(np.percentile(lat, 50)),
        p99_s=float(np.percentile(lat, 99)),
        cost_per_1k=cost / len(lat) * 1000.0,
        batches=batches, requests=len(lat),
        mean_batch=len(lat) / batches,
        records=records if keep_records else None)


def optimize_policy(*, arrival_rate: float, flops_per_request: float,
                    slo_s: float, seed: int = 0,
                    batches=(1, 2, 4, 8, 16, 32, 64),
                    timeouts=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0),
                    memories=(1024, 2048, 4096, 8192)) -> Tuple[
                        Optional[ServePolicy], Optional[ServeStats], Dict]:
    """Cheapest (B, tau, memory) meeting the p99 SLO. Returns
    (policy, stats, search_log); policy None if the SLO is infeasible."""
    best = None
    log = {"evaluated": 0, "feasible": 0}
    for mem in memories:
        for B in batches:
            for tau in timeouts:
                pol = ServePolicy(B, tau, mem)
                st = simulate(pol, arrival_rate=arrival_rate,
                              flops_per_request=flops_per_request, seed=seed)
                log["evaluated"] += 1
                if st.p99_s <= slo_s:
                    log["feasible"] += 1
                    if best is None or st.cost_per_1k < best[1].cost_per_1k:
                        best = (pol, st)
    if best is None:
        return None, None, log
    return best[0], best[1], log
