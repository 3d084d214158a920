"""CommPlan: the communication schedule as a first-class IR.

A copy of the JAX package's ``core/comm.py`` (it needs no framework);
the port's ``LocalWorkerPool`` consumes ``build_plan`` and ``CommPlan``.

The paper names communication as *the* serverless bottleneck and answers
it with a hierarchical ScatterReduce dataflow (Section 3.3, Fig. 5).
This module makes that schedule a typed, transformable object — one plan
that every cost-bearing layer consumes:

 - the **analytic model** (``serverless.worker.iteration_time`` /
   ``core.cost_model.epoch_estimate``) prices a plan in closed form
   with per-phase fan-in contention;
 - the **event engine** (``serverless.events.EventEngine``)
   executes the same phases generically on contended ``SharedLink``s;
 - the **semantic path** (``LocalWorkerPool``) maps the plan's strategy
   to matching real-gradient numerics (shard aggregation, tree means,
   top-k + error-feedback sparse sync).

Phase DAG contract
------------------
A ``CommPlan`` is a linear per-iteration sequence of ``CommPhase``s; the
DAG edges are implicit: phase *i+1* depends on phase *i* for each worker,
and a ``barrier_after`` phase additionally joins **all** workers before
anyone proceeds (bsp only; ssp/async drop the joins). Each phase names:

 - ``store``: which store link it contends on ("param" | "object");
 - ``nbytes``: bytes moved by one (busiest) *participating* worker;
 - ``fan_in``: how many workers participate concurrently — both the
   closed-form contention divisor and the engine's participant count
   (workers ``0..fan_in-1`` execute the phase, the rest skip straight to
   its barrier — aggregators are relabeled to the lowest ids);
 - ``requests``: store round-trips (latency multiplier);
 - ``cpu_s``: post-transfer local work (e.g. densifying a sparse payload).

The symbolic payload shape (``units`` items of ``item_frac``·G each, each
aggregating ``item_inputs`` worker gradients) is what ``compress`` uses
to rewrite wire bytes without re-deriving the topology.

Strategies
----------
 - ``ps(G, n)``            — Cirrus-style central store: upload G,
                             download n·G (``store="object"`` is the
                             Siren-style S3 variant).
 - ``scatter_reduce(G, n)``— the paper's ScatterReduce (Fig. 5): shard →
                             aggregate → re-upload → gather; O(G) per
                             worker. Legacy scheme name: ``"hier"``.
 - ``hier(G, n, branching, levels)`` — a multi-level aggregation tree:
                             groups of ``branching`` reduce level by
                             level to one root, which re-uploads the
                             global aggregate; cuts the central store's
                             O(n·G) download to O(G) without sharding.

``compress(ratio)`` applies the top-k(+error-feedback) wire model of
``core.compression``: a single worker's contribution costs
``2·ratio`` of dense (4B value + 4B index per kept entry); an aggregate
of j contributions densifies to ``min(1, j·ratio)``; every download of a
compressed payload pays a decompress (sparse scatter-add) CPU charge.

Overlap contract (``pipeline(depth)``)
--------------------------------------
``pipeline(depth)`` makes a plan *overlap-aware*: compute splits into
``depth`` micro-batch segments (gradient accumulation — the numerics are
unchanged), and the plan's **leading upload run** — the UL phases before
the first barrier or download, which move the worker's *own* gradient and
therefore exist per segment — is marked ``overlappable``. Every consumer
executes the same schedule:

 - segment *i*'s share (``nbytes / depth``, full ``requests`` round-trips)
   of each overlappable UL may hide under compute of segment *i+1*;
 - barrier semantics are preserved: a ``barrier_after`` on an overlappable
   phase joins all workers only after the **last** segment's upload —
   never per segment — and every post-barrier/download phase stays
   strictly sequential (its input is aggregated data, not local compute);
 - the closed form prices the iteration as
   ``max(compute, hidden comm) + exposed comm + bubble`` with
   ``bubble = min(compute, hidden comm) / depth`` — ``depth=1`` is
   byte-identical to the unpipelined plan, ``depth→∞`` hides
   ``min(compute, hidden comm)`` entirely;
 - store-busy (keep-alive billing) is *unchanged by overlap*: a hidden
   transfer still holds the store while it runs, so the billing basis is
   the transfer time itself, hidden or not — and it accrues **only for
   ``store == "param"`` phases** (an S3-path plan never bills the Redis
   container; see ``plan_times``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

# (4B value + 4B index) / 4B dense — the top-k wire overhead per kept entry
INDEX_OVERHEAD = 2.0
# sparse scatter-add rate when densifying a received compressed payload
DECOMPRESS_GBPS = 2.0


@dataclasses.dataclass(frozen=True)
class CommPhase:
    """One step of the per-iteration communication schedule.

    ``nbytes`` is always derivable as ``units * item_frac * G *
    wire_factor`` — constructors precompute it so consumers never touch
    the symbolic fields, while ``CommPlan.compress`` rewrites it."""
    name: str
    store: str                   # "param" | "object"
    nbytes: float                # bytes moved by one busiest participant
    requests: int = 1            # store round-trips -> latency multiplier
    barrier_after: bool = False  # bsp join of ALL workers (engine)
    fan_in: int = 1              # concurrently participating workers
    direction: str = "ul"        # "ul" (worker->store) | "dl" (store->worker)
    level: int = 0               # hierarchy level (0 = flat)
    cpu_s: float = 0.0           # post-transfer local work (decompress)
    # overlap (set by CommPlan.pipeline): this phase moves the worker's own
    # per-segment gradient, so segment i's share may hide under compute of
    # segment i+1. overlap_group records the phase's position within the
    # upload run (informational — consumers execute overlappable phases
    # in plan order)
    overlappable: bool = False
    overlap_group: int = 0
    # symbolic payload shape (used by compress):
    units: int = 1               # payload items moved by the busiest worker
    item_frac: float = 1.0       # dense size of one item, fraction of G
    item_inputs: int = 1         # worker gradients aggregated per item


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """A size-independent description of a communication schedule — what
    the Bayesian optimizer searches over and the scheduler deploys. Bind
    it to a workload/fleet with ``build_plan(spec, grad_bytes, n)``."""
    strategy: str = "scatter_reduce"   # "ps" | "scatter_reduce" | "hier"
    ratio: float = 1.0                 # top-k keep ratio; 1.0 = dense
    branching: int = 0                 # hier fan-in per node; 0 = default 4
    levels: int = 0                    # hier depth; 0 = full depth
    store: str = "param"               # ps only: "object" = S3 (Siren)
    pipeline_depth: int = 1            # micro-batch overlap segments; 1 = off

    def __post_init__(self):
        if self.strategy not in ("ps", "scatter_reduce", "hier"):
            raise ValueError(f"unknown comm strategy {self.strategy!r}")
        if not 0.0 < self.ratio <= 1.0:
            raise ValueError("compress ratio must be in (0, 1], "
                             f"got {self.ratio}")
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1, "
                             f"got {self.pipeline_depth}")


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """A bound communication schedule for one (workload, fleet size)."""
    strategy: str
    n_workers: int
    grad_bytes: float            # G, including any extra upload bytes
    phases: Tuple[CommPhase, ...]
    ratio: float = 1.0
    branching: int = 0
    levels: int = 0
    pipeline_depth: int = 1      # micro-batch segments (1 = no overlap)

    @property
    def wire_bytes(self) -> float:
        """Fleet-wide bytes on the wire per iteration (all participants)."""
        return sum(ph.fan_in * ph.nbytes for ph in self.phases)

    @property
    def cpu_s(self) -> float:
        """Busiest worker's per-iteration post-transfer CPU time."""
        return sum(ph.cpu_s for ph in self.phases)

    @property
    def overlappable_phases(self) -> Tuple[CommPhase, ...]:
        """The leading upload run that may hide under segmented compute
        (empty unless ``pipeline_depth > 1``)."""
        return tuple(ph for ph in self.phases if ph.overlappable)

    def pipeline(self, depth: int) -> "CommPlan":
        """Overlap transform: split compute into ``depth`` micro-batch
        segments and mark the plan's leading upload run — the UL phases
        before the first barrier or download, which move the worker's own
        gradient — as overlappable with the *next* segment's compute.

        Barrier semantics are preserved: a ``barrier_after`` on an
        overlappable phase still joins all workers, but only once, after
        the last segment's upload; post-barrier phases (aggregate
        downloads, re-uploads) never overlap. ``depth=1`` rebuilds the
        sequential plan exactly (idempotent round-trip)."""
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        phases = []
        blocked = depth == 1
        group = 0
        for ph in self.phases:
            ov = (not blocked) and ph.direction == "ul"
            if ph.barrier_after or ph.direction == "dl":
                blocked = True
            phases.append(dataclasses.replace(
                ph, overlappable=ov, overlap_group=group if ov else 0))
            if ov:
                group += 1
        return dataclasses.replace(self, phases=tuple(phases),
                                   pipeline_depth=depth)

    def compress(self, ratio: float,
                 decompress_gbps: float = DECOMPRESS_GBPS) -> "CommPlan":
        """Top-k wire model: a raw contribution (``item_inputs == 1``)
        shrinks to ``INDEX_OVERHEAD * ratio`` of dense; an aggregate of j
        contributions densifies to ``min(1, j*ratio)``. Either factor is
        capped at dense — a sender whose sparse encoding would exceed the
        dense payload falls back to dense, so wire bytes are monotone in
        the keep ratio. Downloads of still-sparse payloads pay a
        decompress CPU charge. ``ratio=1.0`` rebuilds the dense plan
        (idempotent round-trip from any compressed plan)."""
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"compress ratio must be in (0, 1], got {ratio}")
        phases = []
        for ph in self.phases:
            factor = min(1.0, (INDEX_OVERHEAD * ratio if ph.item_inputs <= 1
                               else ph.item_inputs * ratio))
            nbytes = ph.units * ph.item_frac * self.grad_bytes * factor
            cpu = (nbytes / 1e9 / decompress_gbps
                   if ph.direction == "dl" and factor < 1.0 else 0.0)
            phases.append(dataclasses.replace(ph, nbytes=nbytes, cpu_s=cpu))
        return dataclasses.replace(self, phases=tuple(phases), ratio=ratio)


# ---------------------------------------------------------------------------
# strategy constructors
# ---------------------------------------------------------------------------


def ps(grad_bytes: float, n_workers: int, *,
       store: str = "param") -> CommPlan:
    """Central parameter store (Cirrus; ``store="object"`` = Siren/S3):
    every worker uploads its gradient, then downloads everyone's."""
    n, G = n_workers, grad_bytes
    phases = (
        CommPhase("UL-grad", store, G, 1, barrier_after=True, fan_in=n,
                  direction="ul", units=1, item_frac=1.0, item_inputs=1),
        CommPhase("DL-grad", store, n * G, 1, fan_in=n, direction="dl",
                  units=n, item_frac=1.0, item_inputs=1),
    )
    return CommPlan("ps", n, G, phases)


def scatter_reduce(grad_bytes: float, n_workers: int,
                   n_shards: Optional[int] = None) -> CommPlan:
    """The paper's ScatterReduce (Fig. 5): every worker uploads m shards,
    worker j aggregates shard j from all workers and re-uploads it, then
    everyone gathers the m aggregated shards — O(G) per worker."""
    n, G = n_workers, grad_bytes
    m = n_shards or n
    # each of the busiest aggregators owns ceil(m/n) shards; with m < n
    # the n-m idle workers don't help and the busy ones pull n*G/m
    # (paper footnote 4: "m less than n will cause some workers to be
    # idle during aggregation, which will affect performance")
    spa = max(math.ceil(m / n), 1)
    phases = (
        CommPhase("UL-Shard", "param", G, m, barrier_after=True, fan_in=n,
                  direction="ul", units=m, item_frac=1.0 / m, item_inputs=1),
        CommPhase("DL-Shard", "param", spa * n * (G / m), spa * n, fan_in=n,
                  direction="dl", units=spa * n, item_frac=1.0 / m,
                  item_inputs=1),
        CommPhase("UL-aggr", "param", spa * G / m, spa, barrier_after=True,
                  fan_in=n, direction="ul", units=spa, item_frac=1.0 / m,
                  item_inputs=n),
        CommPhase("DL-grad", "param", m * (G / m), m, fan_in=n,
                  direction="dl", units=m, item_frac=1.0 / m, item_inputs=n),
    )
    return CommPlan("scatter_reduce", n, G, phases)


def hier(grad_bytes: float, n_workers: int, *, branching: int = 4,
         levels: int = 0) -> CommPlan:
    """Multi-level aggregation tree: at level l, the surviving partial
    aggregates upload and groups of ``branching`` of them are pulled and
    reduced by one aggregator each, until a single root holds the global
    aggregate; the root re-uploads it and everyone downloads O(G).

    ``levels`` caps the explicit depth (0 = full ``ceil(log_b n)``); a
    shallower tree makes the last level's aggregator pull everything
    that is left — levels=1 degenerates to a single reducing root."""
    n, G = n_workers, grad_bytes
    b = max(branching, 2)
    full = max(math.ceil(math.log(n, b)), 1) if n > 1 else 0
    L = min(levels, full) if levels > 0 else full
    phases: List[CommPhase] = []
    m_prev = n
    for lvl in range(1, L + 1):
        m = 1 if lvl == L else max(math.ceil(m_prev / b), 1)
        per_agg = math.ceil(m_prev / m)
        inputs = max(math.ceil(n / m_prev), 1)   # grads per uploaded partial
        phases.append(CommPhase(
            f"UL-l{lvl}", "param", G, 1, barrier_after=True, fan_in=m_prev,
            direction="ul", level=lvl, units=1, item_frac=1.0,
            item_inputs=inputs))
        phases.append(CommPhase(
            f"DL-l{lvl}", "param", per_agg * G, per_agg, fan_in=m,
            direction="dl", level=lvl, units=per_agg, item_frac=1.0,
            item_inputs=inputs))
        m_prev = m
    phases.append(CommPhase(
        "UL-root", "param", G, 1, barrier_after=True, fan_in=1,
        direction="ul", level=L + 1, units=1, item_frac=1.0, item_inputs=n))
    phases.append(CommPhase(
        "DL-grad", "param", G, 1, fan_in=n, direction="dl", level=L + 1,
        units=1, item_frac=1.0, item_inputs=n))
    return CommPlan("hier", n, G, tuple(phases), branching=b, levels=L)


_BUILDERS = {"ps": ps, "scatter_reduce": scatter_reduce, "hier": hier}

# legacy scheme strings (the paper called its ScatterReduce dataflow
# "hierarchical", hence the historical "hier" alias for scatter_reduce)
_SCHEME_ALIASES = {
    "hier": CommSpec("scatter_reduce"),
    "scatter_reduce": CommSpec("scatter_reduce"),
    "ps": CommSpec("ps"),
    "ps_s3": CommSpec("ps", store="object"),
}


def parse_scheme(scheme: str, topk_ratio: float = 0.05) -> CommSpec:
    """Map a legacy scheme string to its ``CommSpec``."""
    if scheme in _SCHEME_ALIASES:
        return _SCHEME_ALIASES[scheme]
    if scheme == "hier_topk":
        return CommSpec("scatter_reduce", ratio=topk_ratio)
    raise ValueError(f"unknown comm scheme {scheme!r}")


CommLike = Union[str, CommSpec, CommPlan]


def build_plan(comm: CommLike, grad_bytes: float, n_workers: int,
               n_shards: Optional[int] = None,
               extra_upload_bytes: float = 0.0,
               topk_ratio: float = 0.05) -> CommPlan:
    """Resolve a scheme string / ``CommSpec`` / prebuilt ``CommPlan`` into
    the bound plan for this (workload, fleet size)."""
    G = grad_bytes + extra_upload_bytes
    if isinstance(comm, CommPlan):
        if comm.n_workers != n_workers:
            raise ValueError(f"plan built for n={comm.n_workers}, "
                             f"deployment has n={n_workers}")
        if not math.isclose(comm.grad_bytes, G, rel_tol=1e-9):
            raise ValueError(f"plan built for G={comm.grad_bytes:.0f} bytes,"
                             f" workload moves {G:.0f} (incl. extra upload)")
        return comm
    if isinstance(comm, str):
        comm = parse_scheme(comm, topk_ratio)
    if comm.strategy == "ps":
        plan = ps(G, n_workers, store=comm.store)
    elif comm.strategy == "scatter_reduce":
        plan = scatter_reduce(G, n_workers, n_shards=n_shards)
    else:
        plan = hier(G, n_workers, branching=comm.branching or 4,
                    levels=comm.levels)
    if comm.ratio < 1.0:
        plan = plan.compress(comm.ratio)
    if comm.pipeline_depth > 1:
        plan = plan.pipeline(comm.pipeline_depth)
    return plan


# ---------------------------------------------------------------------------
# closed-form pricing (the analytic path's view of a plan)
# ---------------------------------------------------------------------------


def phase_time(ph: CommPhase, param_store, object_store,
               fn_bw_gbps: float, segments: int = 1) -> float:
    """One phase's closed-form seconds: per-request latency plus bytes at
    ``min(function pipe, store aggregate / fan_in)`` — the fan-in is the
    static contention divisor (the event engine relaxes it to *actual*
    overlap on the ``SharedLink``). With ``segments > 1`` (a pipelined
    overlappable phase) the payload moves as that many sub-transfers: the
    bytes term is unchanged, the per-request latency is paid once per
    segment."""
    s = max(segments, 1)
    if ph.store == "param":
        one = (param_store.xfer_time(ph.nbytes / s, concurrent=ph.fan_in,
                                     per_fn_gbps=fn_bw_gbps)
               + param_store.latency_s * max(ph.requests - 1, 0))
    else:
        one = (object_store.put_time(ph.nbytes / s, concurrent=ph.fan_in)
               + object_store.latency_s * max(ph.requests - 1, 0))
    return one * s


def plan_times(plan: CommPlan, param_store, object_store,
               fn_bw_gbps: float) -> Tuple[Dict[str, float], float]:
    """-> (per-phase seconds incl. decompress CPU, store-busy seconds).

    The second value is the time the **param store** is actually held by
    transfers — the keep-alive billing basis. Only ``store == "param"``
    phases accrue it: an object-store phase (the Siren-style ``ps_s3``
    plan) never holds the Redis container, so billing it there would
    charge for a store the plan does not touch. Decompress CPU runs on
    the worker with no store outstanding, so it is in the phase times
    (wall clock) but **not** in store-busy. Overlappable phases of a
    pipelined plan are priced as ``pipeline_depth`` sub-transfers;
    hiding them under compute changes the *iteration* wall-clock (see
    ``overlap_iteration_time``), never the store-busy seconds — a hidden
    transfer still holds the store while it runs."""
    out: Dict[str, float] = {}
    busy = 0.0
    for ph in plan.phases:
        t = phase_time(ph, param_store, object_store, fn_bw_gbps,
                       segments=plan.pipeline_depth if ph.overlappable else 1)
        if ph.store == "param":
            busy += t
        out[ph.name] = t + ph.cpu_s
    return out, busy


def overlap_iteration_time(compute_s: float, hidden_comm_s: float,
                           exposed_comm_s: float,
                           depth: int) -> Dict[str, float]:
    """Closed-form pipelined iteration: compute runs as ``depth``
    back-to-back segments of ``compute_s / depth``; segment *i*'s share
    of the overlappable uploads starts once segment *i* lands and queues
    behind segment *i-1*'s share. The last upload therefore completes at

        ``max(compute, hidden) + min(compute, hidden) / depth``

    (a fill/drain bubble of one segment of the shorter side), after
    which the exposed phases run sequentially. ``depth=1`` degenerates
    to the fully sequential ``compute + hidden + exposed``."""
    c, u = compute_s, hidden_comm_s
    d = max(depth, 1)
    window = max(c, u) + min(c, u) / d
    return {"total": window + exposed_comm_s,
            "bubble": min(c, u) / d if d > 1 else 0.0,
            "comm_hidden": (c + u) - window,
            "comm_exposed": exposed_comm_s + (window - c)}
