"""Discrete-event execution core for the serverless simulator.

The closed-form ``epoch_estimate`` (repro_torch.core.cost_model) costs a whole
epoch in one expression — nothing can *happen* inside it. This engine
replays the same epoch as a time-ordered event simulation with one state
machine per worker::

    invoke -> cold-start -> [data-fetch] -> { compute ->
        <CommPlan phases> -> step }* -> finish

The per-iteration communication is not hard-coded: the engine executes
the same ``repro_torch.core.comm.CommPlan`` the analytic model prices, phase
by phase. The phase DAG contract it honors:

  - phases run in sequence per worker; workers ``0..fan_in-1``
    participate in a phase (aggregators relabeled to the lowest ids),
    everyone else skips it;
  - a participating worker opens one transfer of ``nbytes`` on the
    phase's store link (``requests`` round-trips of setup latency), so
    hierarchy levels contend on the *real* ``SharedLink`` — and interact
    with caps, failures, shocks, and cross-job traffic;
  - ``cpu_s`` (e.g. densifying a compressed payload) computes after the
    transfer, off the link — the store's keep-alive window excludes it;
  - in bsp, ``barrier_after`` joins **all** n workers before anyone
    proceeds; ssp(k)/async drop the joins and keep only their gates;
  - only ``store == "param"`` phases count toward the param store's
    keep-alive window — an object-store plan (``ps_s3``) bills the Redis
    container nothing;
  - a **pipelined** plan (``CommPlan.pipeline(depth)``) runs each
    iteration as ``depth`` compute segments with the overlappable
    leading uploads hidden underneath: the worker state machine gains a
    second activity slot (a compute lane and a transfer lane running
    concurrently), segment *i*'s upload share starts once segment *i*'s
    compute lands and queues behind segment *i-1*'s share, and the
    phase's barrier joins only after the *last* segment's upload.
    Duration-cap restarts pause **both** lanes and resume them with
    their progress; failures and shocks lose both and redo the
    iteration from its boundary.

This makes the paper's dynamics first-class:

  - **Contended stores**: transfers share store bandwidth only while they
    actually overlap (``SharedLink`` processor sharing), instead of the
    analytic model's static ``concurrent=n`` divisor.
  - **Heterogeneous fleets**: a ``FleetSpec`` gives each worker its own
    ``(memory_mb, tier)`` — per-worker compute rate (``compute_time``),
    network cap (``fn_net_gbps``, carried as a per-flow cap on the shared
    link), and GB-second billing rate. ``FleetSpec.homogeneous`` reproduces
    the classic ``(n, memory_mb)`` deployment exactly.
  - **Stragglers**: per-(worker, iteration) lognormal compute multipliers
    (mean 1, so the zero-variance limit reproduces the analytic model).
  - **Mid-flight failures**: a worker dies partway through an iteration,
    re-invokes, restores the checkpoint from the ObjectStore, and redoes
    the iteration — stalling its barrier peers, as it would on Lambda.
  - **Correlated failures**: a ``ShockModel`` layers a shared-shock process
    on top of the independent per-iteration ``failure_rate``: shocks arrive
    as a Poisson process and each one kills a random subset of the fleet at
    once (optionally only a tier, e.g. "spot"), losing in-flight work.
  - **Multi-job contention**: several engines can register into one
    ``ContentionDomain`` — a shared clock + event queue. Engines that use
    the same ``ParamStore``/``ObjectStore`` then contend on the *same*
    ``SharedLink``, so cross-job transfers slow each other by their actual
    overlap (the "noisy neighbor" regime of arXiv 2105.07806).
  - **Duration caps**: each invocation may hold at most
    ``max_duration_s - init - restore`` seconds of work; the engine
    checkpoints through the ObjectStore and restarts mid-segment (billing
    n requests per restart wave, per Lambda semantics).
  - **sync_mode**: "bsp" runs the comm plan's barriers; "ssp(k)" gates a
    worker only when it runs k iterations ahead of the slowest peer;
    "async" removes all inter-worker waits. (``LocalWorkerPool`` carries
    the matching stale-gradient *numerics*.)
  - **Mid-epoch adaptation**: ``on_iteration`` observes every global
    iteration completion; returning True checkpoints and stops the epoch
    early so the scheduler can re-optimize *mid-epoch*.

In the zero-variance, zero-failure, bsp limit the engine reproduces
``epoch_estimate`` wall-clock and cost within 1% (tested); with any
variance it yields the tail behavior the analytic path cannot express.

Throughput machinery (the 10k-worker regime; see docs/PERF.md):

  - the event queue is a bucketed **calendar queue** dispatching
    ``(t, seq, fn, arg)`` records — hot events are prebound methods with
    a tuple payload, not a fresh closure per event;
  - stochastic draws are **vectorized**: per-epoch ``(n, iters)`` blocks
    of straggler multipliers and failure outcomes are drawn in one numpy
    call per stream and consumed in per-worker attempt order, so
    same-seed runs stay bit-identical;
  - in the deterministic homogeneous bsp regime, identical workers that
    move in lockstep are **coalesced** into cohorts (split only at
    CommPlan ``fan_in`` boundaries) that advance as one state machine —
    per-worker billing records and trace lines are still emitted, so
    every bookkeeping invariant is preserved exactly;
  - ``record_trace=False`` skips trace-line accumulation entirely;
  - per-event fleet scans (min-iteration, all-finished) are replaced by
    an iteration histogram and an unfinished counter.

A copy of the JAX package's ``serverless/events.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import rng as rng_streams
from repro_torch.serverless.backends import BackendLike, resolve_backend
from repro_torch.serverless.platform import (CHECKPOINT_RESTORE_S,
                                       DATA_OBJECT_BYTES, LAMBDA_GB_SECOND,
                                       LAMBDA_MAX_DURATION_S,
                                       LAMBDA_PER_REQUEST, FleetSpec,
                                       InvocationRecord, ServerlessPlatform,
                                       ShockModel, fn_net_gbps)
from repro_torch.core.comm import CommLike, CommPlan, build_plan
from repro_torch.serverless.stores import (ECS_GB_HOUR, ECS_VCPU_HOUR, S3_GET_PER_1K,
                                     ObjectStore, ParamStore, SharedLink)
from repro_torch.serverless.worker import (Workload, compute_time,
                                     fleet_local_batches, parse_sync_mode)

_EPS_GB = 1e-12          # flow remainder considered complete (~1e-3 byte)
_INF = math.inf


class CalendarQueue:
    """Bucketed future-event list: a ring of time-sliced buckets, each a
    small heap. Push hashes an event to the bucket covering its
    timestamp; pop scans forward from the current bucket, so dequeue
    order is exactly the ``(t, seq)`` total order a global heap gives,
    with O(1) expected push/pop instead of O(log n).

    The bucket count doubles (halves) when occupancy grows (shrinks)
    past 2 events/bucket, and the bucket width is re-derived from the
    observed inter-event gaps on each resize (Brown's calendar-queue
    heuristic). A scan that walks a whole empty "year" jumps straight to
    the bucket holding the global minimum, so sparse far-future events
    (keep-alive caps, shock arrivals) cannot stall the scan."""

    __slots__ = ("_nb", "_width", "_buckets", "_cur_abs", "_size", "_cold")

    def __init__(self, nbuckets: int = 32, width: float = 1.0):
        self._nb = nbuckets
        self._width = width
        self._buckets: List[list] = [[] for _ in range(nbuckets)]
        self._cur_abs = 0            # absolute (un-wrapped) bucket index
        self._size = 0
        self._cold = 0               # consecutive under-occupancy pops

    def __len__(self) -> int:
        return self._size

    def __bool__(self) -> bool:
        return self._size > 0

    def push(self, ev: tuple):
        """``ev`` sorts by its leading ``(t, seq)`` fields."""
        ab = int(ev[0] / self._width)
        if ab < self._cur_abs:       # same-instant event during dispatch
            ab = self._cur_abs
        if self._size == 0:
            self._cur_abs = ab       # fast-forward an idle scan position
        heapq.heappush(self._buckets[ab % self._nb], ev)
        self._size += 1
        if self._size > 2 * self._nb:
            self._resize(2 * self._nb)

    def pop(self) -> tuple:
        if not self._size:
            raise IndexError("pop from empty CalendarQueue")
        if self._nb > 32 and self._size < self._nb // 6:
            # shrink with hysteresis, straight to the occupancy-matched
            # size: a periodic workload (a fan-out window's wave every
            # iteration) keeps its ring across the brief sparse phase
            # instead of paying a shrink+regrow cycle per period
            self._cold += 1
            if self._cold >= 128:
                self._cold = 0
                nb = 32
                while nb < self._size:
                    nb <<= 1
                self._resize(max(nb, 32))
        else:
            self._cold = 0
        nb, width, buckets = self._nb, self._width, self._buckets
        ab = self._cur_abs
        scanned = 0
        while True:
            b = buckets[ab % nb]
            if b and b[0][0] < (ab + 1) * width:
                self._cur_abs = ab
                self._size -= 1
                return heapq.heappop(b)
            ab += 1
            scanned += 1
            if scanned > nb:
                # a full year of buckets is empty at this resolution:
                # jump to the bucket holding the global minimum
                head = min(b[0] for b in buckets if b)
                ab = max(int(head[0] / width), self._cur_abs)
                scanned = 0

    def push_bulk(self, evs: list):
        """Insert many events in one call: one resize check for the whole
        batch and no per-event method dispatch. The dequeue order is the
        ``(t, seq)`` record order either way, so bulk insertion is
        observationally identical to pushing one at a time."""
        if not evs:
            return
        nb, width, buckets = self._nb, self._width, self._buckets
        cur = self._cur_abs
        empty = self._size == 0
        for ev in evs:
            ab = int(ev[0] / width)
            if ab < cur:             # same-instant event during dispatch
                ab = cur
            if empty:                # fast-forward an idle scan position
                self._cur_abs = cur = ab
                empty = False
            heapq.heappush(buckets[ab % nb], ev)
        self._size += len(evs)
        new_nb = self._nb
        while self._size > 2 * new_nb:
            new_nb *= 2
        if new_nb != self._nb:
            self._resize(new_nb)

    def _resize(self, new_nb: int):
        evs = [e for b in self._buckets for e in b]
        if evs:
            # ~3 events per bucket-width keeps both the scan and the
            # per-bucket heaps short; the span/count estimate of the mean
            # gap needs no sort, so a resize is O(n)
            lo = min(evs)[0]
            hi = max(ev[0] for ev in evs)
            if hi > lo:
                self._width = max(3.0 * (hi - lo) / len(evs), 1e-9)
            base = int(lo / self._width)
        else:
            base = 0
        self._nb = new_nb
        self._buckets = [[] for _ in range(new_nb)]
        self._cur_abs = base
        width = self._width
        for e in evs:
            ab = int(e[0] / width)
            self._buckets[(ab if ab > base else base) % new_nb].append(e)
        for b in self._buckets:
            if len(b) > 1:
                b.sort()


class _Transfer:
    """A pausable store transfer: ``requests * latency`` of setup, then a
    flow on the link at the processor-sharing rate. ``cap_gbps`` is the
    issuing worker's function-network limit (per-flow cap on the link).
    ``weight`` counts the member streams a coalesced cohort's single
    flow stands for (bytes and rate stay per member)."""
    _ids = itertools.count()

    __slots__ = ("fid", "link", "remaining_gb", "total_gb", "latency_left",
                 "setup_latency_s", "cb", "token", "is_sync", "cap_gbps",
                 "weight", "prio")

    def __init__(self, link: SharedLink, nbytes: float, latency_s: float,
                 cb: Callable[[], None], is_sync: bool,
                 cap_gbps: Optional[float] = None, weight: int = 1,
                 prio: float = 1.0):
        self.fid = next(self._ids)
        self.link = link
        self.remaining_gb = nbytes / 1e9
        self.total_gb = self.remaining_gb
        self.latency_left = latency_s
        self.setup_latency_s = latency_s
        self.cb = cb
        self.token = 0          # invalidates scheduled setup events on pause
        self.is_sync = is_sync  # gradient sync (param-store keep-alive window)
        self.cap_gbps = cap_gbps
        self.weight = weight
        self.prio = prio        # water-filling priority (SharedLink.rates)


class ContentionDomain:
    """Shared clock + event queue + store links for one or more engines.

    Each ``EventEngine`` owns a private domain by default (single-job runs
    are unchanged). To co-simulate jobs, construct one domain and pass it
    to every engine: engines that name the same store object share its
    ``SharedLink``, so their transfers contend by actual overlap::

        dom = ContentionDomain()
        a = EventEngine(..., param_store=shared_ps, domain=dom, seed=0)
        b = EventEngine(..., param_store=shared_ps, domain=dom, seed=1)
        dom.run()
        ra, rb = a.result(), b.result()
    """

    def __init__(self):
        self.now = 0.0
        self._q = CalendarQueue()
        self._seq = itertools.count()
        self._links: Dict[Tuple[int, str], SharedLink] = {}
        self._engines: List["EventEngine"] = []
        self._groups: Dict[int, List["EventEngine"]] = {}
        self._running = False
        # union of time *any* engine's sync transfers are outstanding: the
        # honest keep-alive window for one param store shared across jobs
        # (per-engine sync_s sums would double-bill the overlap).
        # Accounting is interval-based: engines report their 0<->1
        # sync-outstanding transitions (``_sync_on``/``_sync_off``) and the
        # domain closes [on, off) intervals — no per-time-advance scans.
        self.sync_union_s = 0.0
        self._sync_n = 0        # engines with sync transfers outstanding
        self._sync_t0 = 0.0
        # same union, kept per param store (id) — the billing basis when a
        # store is shared: each engine is billed its proportional share
        self._store_sync: Dict[int, float] = {}
        self._store_n: Dict[int, int] = {}
        self._store_t0: Dict[int, float] = {}
        # union seconds already allocated to taken results, per store —
        # lets late-arriving engines (workflow tasks admitted at t > 0)
        # bill against only the not-yet-allocated remainder
        self._store_billed: Dict[int, float] = {}
    def at(self, t: float, fn: Callable):
        self._q.push((t, next(self._seq), fn, None))

    def at2(self, t: float, fn: Callable, arg):
        """Schedule a record event: ``fn(arg)`` at ``t``. ``fn`` is a
        prebound method and ``arg`` its payload tuple — no per-event
        closure is allocated."""
        self._q.push((t, next(self._seq), fn, arg))

    def at2_bulk(self, items):
        """Bulk-schedule ``(t, fn, arg)`` records in one queue insert —
        the per-iteration compute-finish waves and serving arrival slabs
        ride this. Safe mid-dispatch: dequeue order is the ``(t, seq)``
        total order however events were inserted."""
        seq = self._seq
        self._q.push_bulk([(t, next(seq), fn, arg) for t, fn, arg in items])

    def link_for(self, store, kind: str) -> SharedLink:
        """The one SharedLink all engines in this domain use for ``store``
        (keyed by object identity, so distinct stores never contend)."""
        key = (id(store), kind)
        if key not in self._links:
            self._links[key] = store.link()
        return self._links[key]

    def _register(self, engine: "EventEngine"):
        """Admit an engine. Admission is legal at any point — before the
        first ``run()``, between runs, or *mid-run* (a workflow task whose
        dependencies completed at t > 0): a mid-run admission schedules the
        engine's start at ``max(start_at, now)`` on the live queue."""
        self._engines.append(engine)
        self._groups.setdefault(id(engine.param_store), []).append(engine)
        if len(self._engines) > 1:
            # a second job voids the sole-flow-source premise of any
            # armed drain cascade (see _cascade) — permanently
            for link in self._links.values():
                link.cascade = None
        if self._running:
            # the engine is still mid-__init__ when it registers: defer the
            # launch onto the live queue so it starts (at its own start_at,
            # never in the past) only once fully constructed
            self.at(max(engine.start_at, self.now),
                    lambda: self._launch(engine))
        return len(self._engines) - 1   # job index

    def _launch(self, eng: "EventEngine"):
        if eng._started:
            return
        if eng.start_at <= self.now:
            eng._start()                 # the clock never rewinds
        else:
            self.at(eng.start_at, eng._start)

    def run(self):
        """Run every registered engine to completion on the shared clock.
        May be called again after more engines are admitted: the clock is
        monotonic across calls, and engines with ``start_at`` in the
        future begin exactly then."""
        self._running = True
        try:
            q = self._q
            pop = q.pop
            for eng in list(self._engines):
                self._launch(eng)
            heappop = heapq.heappop
            while q._size:
                # inline CalendarQueue.pop fast path: the head of the
                # current bucket is due within its year — the full
                # pop() handles scans, shrink hysteresis and jumps
                b = q._buckets[q._cur_abs % q._nb]
                if b and b[0][0] < (q._cur_abs + 1) * q._width:
                    q._size -= 1
                    t, _, fn, arg = heappop(b)
                else:
                    t, _, fn, arg = pop()
                if t > self.now:
                    self.now = t
                if arg is None:
                    fn()
                else:
                    fn(arg)
        finally:
            self._running = False
        for eng in self._engines:
            eng._check_complete()

    # -- sync-window (keep-alive) interval accounting ------------------------
    def _sync_on(self, eng):
        """``eng`` now has at least one sync transfer outstanding (its
        count just went 0 -> 1): open its interval, and the store-group
        and domain union intervals if they were closed."""
        now = self.now
        eng._sync_t0 = now
        sid = eng._sid
        n = self._store_n.get(sid, 0)
        if n == 0:
            self._store_t0[sid] = now
        self._store_n[sid] = n + 1
        if self._sync_n == 0:
            self._sync_t0 = now
        self._sync_n += 1

    def _sync_off(self, eng):
        """``eng``'s sync-outstanding count just went 1 -> 0: close its
        interval (and the store/domain unions when it was the last
        engine holding them open)."""
        now = self.now
        eng._sync_busy += now - eng._sync_t0
        sid = eng._sid
        n = self._store_n[sid] - 1
        self._store_n[sid] = n
        if n == 0:
            self._store_sync[sid] = (self._store_sync.get(sid, 0.0)
                                     + (now - self._store_t0[sid]))
        self._sync_n -= 1
        if self._sync_n == 0:
            self.sync_union_s += now - self._sync_t0

    # -- link completion prediction (class-based, lazy) ----------------------
    def _relink(self, link: SharedLink):
        """Flow set changed: refresh the drain predictions. In class mode
        only each class's *earliest* drain target is (re-)keyed in the
        calendar queue, and only when it moved **earlier** than the
        pending prediction — predictions that moved later are left to
        fire early, find nothing drained, and re-arm (lazy deletion).
        Untracked links keep the legacy one-prediction-per-mutation
        scheme."""
        flows = link.flows
        if not flows:
            return
        if link._ntracked == len(flows):
            now = self.now
            for c in link.classes.values():
                if not c.n:
                    continue
                heap = c.heap
                target = c.target
                while True:
                    tgt, fid = heap[0]
                    if target.get(fid) == tgt:
                        break
                    heapq.heappop(heap)          # lazy-deleted entries
                d = tgt - c.served
                if d < 0.0:
                    d = 0.0
                t = now + d / c.rate
                if t < c.pred_t:
                    c.pred_t = t
                    c.pred_id += 1
                    self._q.push((t, next(self._seq),
                                  self._class_event, (link, c, c.pred_id)))
        else:
            link.generation += 1
            t_next = self.now + link.next_completion_dt()
            self.at2(t_next, self._legacy_link_event,
                     (link, link.generation))

    def _class_event(self, payload):
        """One class's predicted earliest drain time arrived."""
        link, c, pid = payload
        if pid != c.pred_id:
            return                               # stale prediction
        c.pred_t = _INF
        flows = link.flows
        if link._ntracked != len(flows) or not c.n:
            return                               # fell off the class path
        now = self.now
        if link.last_t != now:
            if link._active == 1:
                # c is the only active class: advance its served integral
                # inline (identical arithmetic to progress()). The
                # multi-class path stays a real progress() call — tests
                # observe link advances by wrapping it
                c.served += c.rate * (now - link.last_t)
                link.last_t = now
            else:
                link.progress(now)
        served = c.served
        heap, target = c.heap, c.target
        done = None
        while heap:
            tgt, fid = heap[0]
            if target.get(fid) != tgt:
                heapq.heappop(heap)
                continue
            if tgt - served > _EPS_GB:
                break
            # inlined remove_flow for the tracked drain path: same
            # arithmetic, but the live heap entry pops here instead of
            # lingering for lazy deletion, and rates refresh once after
            # the whole batch (nothing observes the intermediate sets)
            heapq.heappop(heap)
            del target[fid]
            tr = flows.pop(fid)
            d = tgt - served
            tr.remaining_gb = d if d > 0.0 else 0.0
            link.generation += 1
            w = tr.weight
            link._total_w -= w
            link._ntracked -= 1
            c.n -= 1
            c.w -= w
            if done is None:
                done = [tr]
            else:
                done.append(tr)
        if done is None:
            # the prediction was made at higher rates (the lazy scheme
            # never re-keys a drain that moved later): re-arm at the
            # class's current earliest drain
            if heap:
                d = heap[0][0] - served
                if d < 0.0:
                    d = 0.0
                t = now + d / c.rate
                c.pred_t = t
                c.pred_id += 1
                self._q.push((t, next(self._seq),
                              self._class_event, (link, c, c.pred_id)))
            return
        if c.n == 0:
            link._active -= 1
            heap.clear()
            c.pred_id += 1
        if link._active == 1 and c.n:
            # single-class fast path: the refresh is the processor-sharing
            # formula and the only class _relink could re-key is this one
            # — both inline (identical arithmetic to the generic path)
            c.rate = rate = min(c.cap, link.aggregate_gbps / link._total_w)
            win = link.cascade
            if (win is not None and c.n > 1 and link.setup == 0
                    and win.pending == 0):
                for tr in done:
                    tr.cb()
                self._cascade(link, c, win)
                return
            while True:
                tgt, fid = heap[0]
                if target.get(fid) == tgt:
                    break
                heapq.heappop(heap)
            d = tgt - served
            if d < 0.0:
                d = 0.0
            t = now + d / rate
            c.pred_t = t
            c.pred_id += 1
            self._q.push((t, next(self._seq),
                          self._class_event, (link, c, c.pred_id)))
            for tr in done:
                tr.cb()
            return
        if link._active:
            link._refresh_rates()
        self._relink(link)
        for tr in done:
            tr.cb()

    def _cascade(self, link: SharedLink, c, win):
        """Inline post-join drain cascade for a fan-out window that owns
        every flow on ``link`` (single window phase, window spanning the
        whole fleet, one engine in the domain — armed via
        ``link.cascade``).

        Once every member has joined, no flow-set change can precede the
        next drain: the remaining schedule is a closed cascade whose
        intermediate completions are pure counter updates (an arriving
        member is bookkeeping; the engine sync count stays positive
        while the last flow is in flight). Replaying the exact per-event
        arithmetic here — progress to the predicted drain time, drain
        every head within eps, refresh the single-class rate — commits
        those drains without dispatching an event each; only the final
        flow (sync-interval close + barrier merge) and anything past the
        invocation's cap deadline go back through the queue."""
        eng = win.eng
        agg = link.aggregate_gbps
        cap = c.cap
        cap_t = win.w.cap_t          # never cascade past a preemption
        heap, target, flows = c.heap, c.target, link.flows
        served = c.served
        rate = c.rate
        t = link.last_t              # == self.now: caller just progressed
        stage = win.stage
        trs = win.trs
        drained = 0
        while c.n > 1:
            while True:              # clean lazy-deleted heads
                tgt, fid = heap[0]
                if target.get(fid) == tgt:
                    break
                heapq.heappop(heap)
            d = tgt - served
            if d < 0.0:
                d = 0.0
            t2 = t + d / rate        # the prediction an event would carry
            if t2 >= cap_t:
                break                # the cap fires first: let it pause
            dt = t2 - t              # mirror SharedLink.progress exactly
            if dt > 0.0:
                served += rate * dt
            t = t2
            nb = 0
            while heap:              # the event's within-eps drain batch
                tgt, fid = heap[0]
                if target.get(fid) != tgt:
                    heapq.heappop(heap)
                    continue
                if tgt - served > _EPS_GB:
                    break
                heapq.heappop(heap)
                del target[fid]
                tr = flows.pop(fid)
                d = tgt - served
                tr.remaining_gb = d if d > 0.0 else 0.0
                link.generation += 1
                link._total_w -= tr.weight
                link._ntracked -= 1
                c.n -= 1
                c.w -= tr.weight
                if tr.is_sync:
                    eng._sync_active -= 1    # stays > 0: last flow lives
                i = tr.cb.args[0]            # cb is partial(_xfer_done, i)
                stage[i] = _FAN_ARRIVED
                trs[i] = None
                nb += 1
                if c.n == 1:
                    break
            if nb == 0:
                break                # fp guard: fall back to a real event
            drained += nb
            rate = c.rate = min(cap, agg / link._total_w)
        c.served = served
        link.last_t = t
        win.arrived += drained
        eng._levents += drained
        # the remainder — the final flow, or everything past the cap —
        # re-enters the normal prediction machinery
        while True:
            tgt, fid = heap[0]
            if target.get(fid) == tgt:
                break
            heapq.heappop(heap)
        d = tgt - served
        if d < 0.0:
            d = 0.0
        tf = t + d / rate
        c.pred_t = tf
        c.pred_id += 1
        self.at2(tf, self._class_event, (link, c, c.pred_id))

    def _legacy_link_event(self, payload):
        """Materialized-fallback drain event (untracked flow sets)."""
        link, gen = payload
        if gen != link.generation:
            return                               # stale prediction
        link.progress(self.now)
        done = link.take_drained(_EPS_GB)
        self._relink(link)
        for tr in done:
            tr.cb()

    def _setup_done(self, payload):
        """A transfer's setup-latency window elapsed: it becomes a flow
        on its link (shared by training engines and serving jobs)."""
        tr, token = payload
        if token != tr.token:
            return                               # paused during setup
        link = tr.link
        link.setup -= 1
        tr.latency_left = 0.0
        if tr.remaining_gb <= _EPS_GB:
            self._relink(link)                   # busy-window bookkeeping
            tr.cb()                              # cb releases the activity slot
            return
        c = link.add_flow(tr, self.now)
        if c is None:
            self._relink(link)
            return
        # a join only lowers rates (water-filling allocations are monotone
        # non-increasing in additions), so every other class's earliest
        # drain moved later — the lazy scheme leaves those to fire early.
        # Only the joined class can need an earlier prediction: re-key it
        # directly (same arithmetic as _relink restricted to c)
        heap, target = c.heap, c.target
        while True:
            tgt, fid = heap[0]
            if target.get(fid) == tgt:
                break
            heapq.heappop(heap)
        d = tgt - c.served
        if d < 0.0:
            d = 0.0
        t = self.now + d / c.rate
        if t < c.pred_t:
            c.pred_t = t
            c.pred_id += 1
            self._q.push((t, next(self._seq),
                          self._class_event, (link, c, c.pred_id)))

    def store_keep_alive_share(self, engine: "EventEngine") -> float:
        """One engine's billing share of its param store's keep-alive
        window: the per-store *union* (the container is alive once, not
        once per job) split across the sharing jobs in proportion to
        their own sync windows — so the per-store billed total always
        equals the union, never double-billing overlap.

        Shares are allocated in result-taking order: each engine takes
        its sync-proportional slice of the union seconds not yet
        allocated to an earlier result. For engines whose results are all
        taken after one ``run()`` this reproduces the plain proportional
        split exactly; for a workflow, where engines join and settle at
        different times, it keeps the running total honest."""
        sid = id(engine.param_store)
        now = self.now
        if self._store_n.get(sid, 0) > 0:
            # the store's keep-alive interval is still open (another job
            # mid-sync): settle it to ``now`` so the pool is current
            self._store_sync[sid] = (self._store_sync.get(sid, 0.0)
                                     + (now - self._store_t0[sid]))
            self._store_t0[sid] = now
        unbilled = [e for e in self._groups.get(sid, [engine])
                    if e._result is None]
        for e in unbilled:
            if e._sync_active > 0:               # settle open engine windows
                e._sync_busy += now - e._sync_t0
                e._sync_t0 = now
        total = sum(e._sync_busy for e in unbilled)
        if total <= 0.0:
            return 0.0
        pool = (self._store_sync.get(sid, 0.0)
                - self._store_billed.get(sid, 0.0))
        share = max(pool, 0.0) * (engine._sync_busy / total)
        self._store_billed[sid] = self._store_billed.get(sid, 0.0) + share
        return share


@dataclasses.dataclass
class EngineResult:
    """What one event-engine epoch (or partial epoch) produced."""
    wall_s: float
    lambda_usd: float
    store_usd: float
    iters_done: int              # globally completed iterations (min worker)
    samples_done: int
    sync_s: float                # this job's own sync-outstanding window
    store_billed_s: float        # keep-alive seconds this job was billed:
                                 # its share of the store's cross-job union
                                 # (== sync_s when the store isn't shared)
    restarts: int                # duration-cap restarts, fleet-wide
    failures: int                # mid-flight failures, fleet-wide (all kinds)
    invocations: int             # Lambda requests billed
    iter_times: List[float]      # completion timestamp per global iteration
    stopped_early: bool
    trace: List[str]
    shock_events: int = 0        # shocks that killed at least one worker
    sim_events: int = 0          # logical per-worker state transitions
                                 # (cohort-weighted: comparable whether or
                                 # not workers were coalesced)
    backend_usd: float = 0.0     # per-second VM/GPU compute dollars
    preemptions: int = 0         # spot price-crossing kills, fleet-wide

    @property
    def cost_usd(self) -> float:
        return self.lambda_usd + self.store_usd + self.backend_usd


class _FleetDraws:
    """Vectorized per-(worker, attempt) stochastic draws.

    Straggler z-scores, failure coins, and failure fractions each come
    from an independent named stream (``repro_torch.core.rng``) and are drawn
    as whole ``(n, block)`` matrices — one numpy call per epoch instead
    of one scalar call per worker-iteration. Column ``k`` is a worker's
    k-th compute *attempt* (a retry after a failure consumes the next
    column), so same-seed runs consume identical values in identical
    order and stay bit-reproducible. Blocks extend lazily when retries
    run past the pre-drawn epoch."""

    __slots__ = ("n", "sigma", "failure_rate", "_block", "_z_rng", "_u_rng",
                 "_f_rng", "_factor", "_fail_u", "_frac", "_cols")

    def __init__(self, n: int, sigma: float, failure_rate: float, seed: int,
                 job_idx: int, iters: int):
        self.n = n
        self.sigma = sigma
        self.failure_rate = failure_rate
        self._block = min(iters + 2, 1024)
        self._z_rng = rng_streams.stream(seed, "straggler", job_idx)
        self._u_rng = rng_streams.stream(seed, "failure", job_idx)
        self._f_rng = rng_streams.stream(seed, "failfrac", job_idx)
        self._factor: Optional[np.ndarray] = None
        self._fail_u: Optional[np.ndarray] = None
        self._frac: Optional[np.ndarray] = None
        self._cols = 0

    def _grow(self, k: int):
        add = self._block
        while k >= self._cols + add:
            add += self._block
        if self.sigma > 0.0:
            z = self._z_rng.standard_normal((self.n, add))
            blk = np.exp(self.sigma * z - 0.5 * self.sigma * self.sigma)
            self._factor = (blk if self._factor is None else
                            np.concatenate([self._factor, blk], axis=1))
        if self.failure_rate > 0.0:
            u = self._u_rng.random_sample((self.n, add))
            f = self._f_rng.random_sample((self.n, add))
            self._fail_u = (u if self._fail_u is None else
                            np.concatenate([self._fail_u, u], axis=1))
            self._frac = (f if self._frac is None else
                          np.concatenate([self._frac, f], axis=1))
        self._cols += add

    def factor(self, wid: int, k: int) -> float:
        """Lognormal straggler multiplier for worker ``wid``, attempt
        ``k`` (1.0 exactly in the zero-variance limit)."""
        if self.sigma <= 0.0:
            return 1.0
        if k >= self._cols:
            self._grow(k)
        return float(self._factor[wid, k])

    def factor_row(self, members: range, k: int) -> np.ndarray:
        """One cohort's straggler multipliers for attempt ``k`` — the
        same cells ``factor(wid, k)`` returns, read as one slice."""
        if self.sigma <= 0.0:
            return np.ones(len(members))
        if k >= self._cols:
            self._grow(k)
        return self._factor[members.start:members.stop, k]

    def failed(self, wid: int, k: int) -> Tuple[bool, float]:
        """(did attempt ``k`` fail mid-iteration, fraction completed)."""
        if self.failure_rate <= 0.0:
            return False, 0.0
        if k >= self._cols:
            self._grow(k)
        return (bool(self._fail_u[wid, k] < self.failure_rate),
                float(self._frac[wid, k]))


class _WorkerState:
    """One engine state machine: a single worker, or a coalesced cohort
    of ``count`` identical workers moving in lockstep (``members`` is the
    contiguous worker-id range; ``wid`` is the leader). All billing
    records, checkpoints, and trace lines are still per member."""

    __slots__ = ("wid", "members", "count", "it", "draws", "inv_recs",
                 "inv_count", "inv_gen", "inv_cont", "cap_gen", "cap_t",
                 "seg_gen", "seg_end", "activity", "pending", "restarting",
                 "finished", "fan", "bill_t0")

    def __init__(self, members: range):
        self.wid = members.start
        self.members = members
        self.count = len(members)
        self.it = 0                   # completed iterations
        self.draws = 0                # compute attempts consumed (draw cursor)
        self.inv_recs: List[InvocationRecord] = []
        self.inv_count = 0
        self.inv_gen = 0              # invalidates stale init-window events
        self.inv_cont = None          # continuation owed by the init window
        self.cap_gen = 0              # invalidates scheduled cap events
        self.cap_t = math.inf         # current invocation's cap deadline
        self.seg_gen = 0              # invalidates scheduled compute ends
        self.seg_end = 0.0
        self.activity: Optional[Tuple] = None   # ("compute"|"transfer"|...)
        self.pending = None           # continuation to run after a restart
        self.restarting = False
        self.finished = False
        self.fan = None               # lazily-built _FanoutWindow (σ>0 cohorts)
        self.bill_t0 = math.inf       # per-second billing anchor (VM backends)


class _PipelineRun:
    """One worker's pipelined iteration window: a compute lane and a
    transfer lane running concurrently (the worker's second activity
    slot).

    The compute lane runs ``depth`` micro-batch segments back-to-back
    (gradient accumulation never waits for the network). The transfer
    lane uploads segment *i*'s share of each overlappable phase —
    ``nbytes / depth`` with the phase's full ``requests`` round-trips —
    as soon as segment *i* has landed **and** segment *i-1*'s share has
    drained (one connection per worker). The window completes when both
    lanes do; the engine then runs the overlappable phases' deferred
    barriers and the sequential remainder of the plan.

    A duration-cap preemption pauses both lanes and resumes them with
    their progress (compute remainder + transfer bytes kept); a shock
    loses both and redoes the iteration from its boundary."""

    __slots__ = ("eng", "w", "d", "seg_s", "phases", "computed", "ul_seg",
                 "ul_phase", "tr", "comp_end", "comp_left", "gen",
                 "computing")

    def __init__(self, eng: "EventEngine", w: "_WorkerState",
                 total_compute_s: float):
        self.eng = eng
        self.w = w
        self.d = eng.plan.pipeline_depth
        self.seg_s = total_compute_s / self.d
        self.phases = [ph for ph in eng._ov_phases if w.wid < ph.fan_in]
        self.computed = 0            # compute segments landed
        self.ul_seg = 0              # segments fully uploaded
        self.ul_phase = 0            # phase index inside the current segment
        self.tr = None               # in-flight transfer (transfer lane)
        self.comp_end = 0.0
        self.comp_left = None        # compute remainder while paused
        self.gen = 0                 # invalidates scheduled compute ends
        self.computing = False

    # -- compute lane --------------------------------------------------------
    def start(self):
        self.w.activity = ("pipeline", self)
        self._start_compute(self.seg_s)

    def _start_compute(self, dur: float):
        self.computing = True
        self.gen += 1
        self.comp_end = self.eng.now + dur
        self.eng.domain.at2(self.comp_end, self.eng._pipe_seg_done,
                            (self, self.gen))

    def _seg_done(self, gen: int):
        if gen != self.gen or not self.computing:
            return
        self.computing = False
        self.computed += 1
        self.eng._levents += self.w.count
        if self.computed < self.d:
            self._start_compute(self.seg_s)
        self._pump_ul()
        self._maybe_finish()

    # -- transfer lane -------------------------------------------------------
    def _pump_ul(self):
        if self.tr is not None or self.ul_seg >= min(self.computed, self.d):
            return
        if not self.phases:          # not a participant in any upload
            self.ul_seg = self.computed
            return

        ph = self.phases[self.ul_phase]

        def done():
            self.tr = None
            self.ul_phase += 1
            if self.ul_phase >= len(self.phases):
                self.ul_phase = 0
                self.ul_seg += 1
            self._pump_ul()
            self._maybe_finish()

        self.tr = self.eng._make_transfer(
            self.w, ph.store, ph.nbytes / self.d, ph.requests, done,
            is_sync=(ph.store == "param"))
        self.eng._begin_setup(self.w, self.tr)

    def _maybe_finish(self):
        if (self.computed >= self.d and self.ul_seg >= self.d
                and self.tr is None):
            w = self.w
            if w.activity is not None and w.activity[0] == "pipeline":
                w.activity = None
            self.eng._pipeline_done(w)

    # -- preemption ----------------------------------------------------------
    def pause(self):
        """Duration-cap preemption: both lanes keep their progress."""
        self.gen += 1
        if self.computing:
            self.comp_left = max(self.comp_end - self.eng.now, 0.0)
            self.computing = False
        else:
            self.comp_left = None
        if self.tr is not None:
            self.eng._detach_transfer(self.tr)

    def resume(self):
        self.w.activity = ("pipeline", self)
        if self.tr is not None:
            self.eng._reattach_transfer(self.w, self.tr)
        if self.comp_left is not None:
            self._start_compute(self.comp_left)
            self.comp_left = None

    def abort(self):
        """Shock kill: in-flight work on both lanes is lost (the caller
        redoes the whole iteration from its boundary)."""
        self.gen += 1
        self.computing = False
        if self.tr is not None:
            self.eng._detach_transfer(self.tr)
            self.tr = None


_FAN_COMPUTING = -1    # _FanoutWindow member stage: compute in flight
_FAN_ARRIVED = -2      # _FanoutWindow member stage: waiting at the merge


class _FanoutWindow:
    """One σ>0 cohort's per-iteration straggler fan-out.

    Under bsp, a cohort's members diverge exactly once per iteration —
    at the stochastic compute draw — and provably re-merge at the plan's
    first ``barrier_after`` phase: past that barrier every member has
    identical state again (deterministic equal transfers preserve
    lockstep, the same argument that makes σ=0 coalescing exact). So the
    cohort machinery runs everything outside the window (invocations,
    data fetch, post-barrier phases, billing), and this window runs the
    divergent stretch per member: one vectorized row of compute draws
    bulk-pushed as per-member finish events, then each member walks its
    participating leading phases as ordinary per-member link flows and
    counts itself arrived; the last arrival joins the cohort barrier
    with the full member weight.

    Every per-member step reuses the exact per-worker primitives
    (``_begin_setup`` / ``_detach_transfer`` / ``_reattach_transfer``,
    the domain's lazy drain predictions, the engine sync-window counter)
    so event times, rates, sync intervals, and logical-event counts are
    identical to the per-worker simulation — only the dispatch
    bookkeeping is batched. A duration-cap preemption pauses the window
    member-by-member (compute remainders kept, flows detached with
    progress) and resumes it after the cohort re-invoke."""

    __slots__ = ("eng", "w", "m", "phases", "bar_name", "cont", "stage",
                 "t_end", "trs", "cbs", "rem", "gen", "arrived", "pending",
                 "cascade_ok", "base_arr")

    def __init__(self, eng: "EventEngine", w: "_WorkerState"):
        self.eng = eng
        self.w = w
        m = self.m = w.count
        phases = eng.plan.phases
        bar = next(i for i, ph in enumerate(phases) if ph.barrier_after)
        self.bar_name = phases[bar].name
        # members share the leader's participation: cohorts cut at every
        # fan_in boundary, so w.wid decides for the whole range
        self.phases = [ph for ph in phases[:bar + 1] if w.wid < ph.fan_in]
        self.cont = lambda: eng._comm_phase(w, bar + 1)
        self.stage = [_FAN_COMPUTING] * m
        self.t_end = [0.0] * m
        self.trs: List[Optional[_Transfer]] = [None] * m
        self.cbs = [functools.partial(self._xfer_done, i) for i in range(m)]
        self.rem: Optional[List[float]] = None
        self.gen = 0
        self.arrived = 0
        self.pending = 0              # members whose compute has not finished
        self.base_arr = np.asarray(eng.base_compute_s[w.wid:w.wid + m])
        # drain-cascade eligibility (see ContentionDomain._cascade): a
        # single window phase and a window spanning the whole fleet mean
        # every flow on that link belongs to this window
        self.cascade_ok = len(self.phases) == 1 and m == eng.n

    def start(self):
        eng = self.eng
        w = self.w
        w.activity = ("fanout", self)
        k = w.draws
        w.draws = k + 1
        factors = eng._draws.factor_row(w.members, k)
        slow = (eng.slowdown_factor
                if (eng.slowdown_at_iter is not None
                    and w.it >= eng.slowdown_at_iter) else None)
        if slow is not None:
            factors = factors * slow
        now = eng.now
        m = self.m
        # the whole compute-end row in one vector op — elementwise IEEE
        # float64, bit-equal to the per-member Python arithmetic
        te_row = (now + self.base_arr * factors).tolist()
        self.gen += 1
        gen = self.gen
        self.arrived = 0
        self.pending = m
        self.stage = [_FAN_COMPUTING] * m
        self.t_end = te_row
        trs = self.trs
        fn = eng._fan_compute_done
        # members' first transfers are known up front: create them and
        # pre-push their setup-elapsed events (at compute end + latency)
        # alongside the compute ends — one bulk insert for the whole
        # window, and the compute handler shrinks to counter updates.
        # Per-worker equivalence: the setup event still fires at exactly
        # compute_end + latency with the same (tr, token) payload, and a
        # preemption stales it through the usual token bump.
        dom = eng.domain
        seq = dom._seq
        ph = self.phases[0] if self.phases else None
        if ph is not None:
            link = eng.links[ph.store]
            if self.cascade_ok and len(dom._engines) == 1:
                link.cascade = self      # sole flow source: cascade legal
            is_sync = ph.store == "param"
            nbytes = ph.nbytes
            lat = link.latency_s * max(ph.requests, 1)
            setup_done = dom._setup_done
            cbs = self.cbs
            net_cap = eng.net_cap
            wid0 = w.members.start
            trs[:] = [_Transfer(link, nbytes, lat, cbs[i], is_sync,
                                cap_gbps=net_cap[wid0 + i]
                                if is_sync else None,
                                prio=eng.link_priority)
                      for i in range(m)]
            # seq order: all compute ends, then all setup elapses. Only
            # equal-timestamp ties could notice (continuous draws: none);
            # each setup still fires at exactly compute_end + latency
            evs = [(te_row[i], next(seq), fn, (self, i, gen))
                   for i in range(m)]
            if lat > 0.0:
                evs += [(te_row[i] + lat, next(seq), setup_done,
                         (tr, tr.token)) for i, tr in enumerate(trs)]
        else:
            trs[:] = [None] * m
            evs = [(te_row[i], next(seq), fn, (self, i, gen))
                   for i in range(m)]
        dom._q.push_bulk(evs)

    def _advance(self, i: int, j: int):
        """Member ``i`` enters window phase ``j`` (or arrives)."""
        phases = self.phases
        if j >= len(phases):
            self.stage[i] = _FAN_ARRIVED
            self.trs[i] = None
            self.arrived += 1
            if self.arrived == self.m:
                self._merge()
            return
        eng = self.eng
        ph = phases[j]
        self.stage[i] = j
        link = eng.links[ph.store]
        is_sync = ph.store == "param"
        cap = (eng.net_cap[self.w.members.start + i]
               if ph.store == "param" else None)
        tr = _Transfer(link, ph.nbytes, link.latency_s * max(ph.requests, 1),
                       self.cbs[i], is_sync, cap_gbps=cap,
                       prio=eng.link_priority)
        self.trs[i] = tr
        if is_sync:
            eng._sync_on()
        eng._begin_setup(self.w, tr)

    def _xfer_done(self, i: int):
        eng = self.eng
        j = self.stage[i] + 1
        if self.trs[i].is_sync:
            # _sync_off inlined: only 1 -> 0 closes the interval
            eng._sync_active -= 1
            if eng._sync_active == 0:
                eng.domain._sync_off(eng)
        eng._levents += 1
        if j >= len(self.phases):        # inlined arrival (the hot case)
            self.stage[i] = _FAN_ARRIVED
            self.trs[i] = None
            self.arrived += 1
            if self.arrived == self.m:
                self._merge()
            return
        self._advance(i, j)

    def _merge(self):
        w = self.w
        w.activity = None
        self.eng._barrier((self.bar_name, w.it), w, self.cont)

    # -- preemption ----------------------------------------------------------
    def pause(self):
        """Duration-cap preemption: every member keeps its progress —
        compute remainders are measured now, in-flight transfers detach
        with their drained bytes (arrived members have nothing open)."""
        eng = self.eng
        now = eng.now
        self.gen += 1                   # stale the scheduled compute ends
        rem = self.rem = [0.0] * self.m
        for i in range(self.m):
            st = self.stage[i]
            if st == _FAN_COMPUTING:
                rem[i] = max(self.t_end[i] - now, 0.0)
                tr = self.trs[i]
                if tr is not None:
                    tr.token += 1       # stale the pre-pushed setup event
            elif st >= 0:
                eng._detach_transfer(self.trs[i])

    def resume(self):
        eng = self.eng
        w = self.w
        w.activity = ("fanout", self)
        self.gen += 1
        gen = self.gen
        now = eng.now
        rem = self.rem
        self.rem = None
        fn = eng._fan_compute_done
        dom = eng.domain
        seq = dom._seq
        setup_done = dom._setup_done
        evs = []
        for i in range(self.m):
            st = self.stage[i]
            if st == _FAN_COMPUTING:
                te = now + rem[i]
                self.t_end[i] = te
                evs.append((te, next(seq), fn, (self, i, gen)))
                tr = self.trs[i]
                if tr is not None and tr.latency_left > 0.0:
                    evs.append((te + tr.latency_left, next(seq), setup_done,
                                (tr, tr.token)))
            elif st >= 0:
                eng._reattach_transfer(w, self.trs[i])
        if evs:
            dom._q.push_bulk(evs)


class EventEngine:
    """Run one epoch of ``workload`` under deployment ``(n, memory_mb)``
    — or a heterogeneous ``fleet`` — as a discrete-event simulation. See
    the module docstring for the semantics; construction mirrors
    ``epoch_estimate``'s signature so the two paths are interchangeable.

    ``record_trace=False`` skips trace accumulation (perf runs);
    ``trace_enabled`` is the accepted legacy alias. ``coalesce`` controls
    lockstep-cohort batching: ``None`` auto-enables it exactly when it is
    provably exact (bsp, zero failures, no shocks, unpipelined plan;
    cohorts cut at every fleet/plan non-uniformity, and σ>0 additionally
    requires the ``_FanoutWindow`` regime — traces off, a bsp re-merge
    barrier, no cpu_s inside the window), ``True`` demands it
    (ValueError if the configuration diverges), ``False`` forces
    per-worker simulation."""

    def __init__(self, workload: Workload, scheme: CommLike, n_workers: int,
                 memory_mb: float, global_batch: int,
                 param_store: ParamStore, object_store: ObjectStore, *,
                 fleet: Optional[FleetSpec] = None,
                 backend: BackendLike = None,
                 link_priority: float = 1.0,
                 shocks: Optional[ShockModel] = None,
                 domain: Optional[ContentionDomain] = None,
                 platform: Optional[ServerlessPlatform] = None,
                 sync_mode: str = "bsp", staleness: int = 0,
                 straggler_sigma: float = 0.0, failure_rate: float = 0.0,
                 framework_init_s: float = 4.0, cold_start_s: float = 2.0,
                 max_duration_s: float = LAMBDA_MAX_DURATION_S,
                 samples: Optional[int] = None, seed: int = 0,
                 slowdown_at_iter: Optional[int] = None,
                 slowdown_factor: float = 1.0,
                 on_iteration: Optional[Callable] = None,
                 record_trace: Optional[bool] = None,
                 trace_enabled: Optional[bool] = None,
                 coalesce: Optional[bool] = None,
                 start_at: float = 0.0,
                 on_complete: Optional[Callable] = None):
        self.w = workload
        self.scheme = scheme
        if fleet is None:
            fleet = FleetSpec.homogeneous(n_workers, memory_mb)
        self.fleet = fleet
        self.n = len(fleet)
        self.mem: Tuple[float, ...] = fleet.memories
        self.global_batch = global_batch
        self.param_store = param_store
        self.object_store = object_store
        self.platform = platform or ServerlessPlatform(
            max_duration_s=max_duration_s, seed=seed)
        self.mode, self.staleness = parse_sync_mode(sync_mode, staleness)
        self.sigma = straggler_sigma
        if not 0.0 <= failure_rate < 1.0:
            # at 1.0 every iteration attempt fails and the simulated epoch
            # (like the real one) would never complete
            raise ValueError("failure_rate must be in [0, 1), "
                             f"got {failure_rate}")
        self.failure_rate = failure_rate
        self.shocks = shocks
        # budget-weight -> network-weight coupling: every transfer this
        # job opens claims the shared links at this priority (matches
        # ServingJob.link_priority; allocator task priorities land here)
        self.link_priority = link_priority
        self.backend = resolve_backend(backend)
        self.restore_s = CHECKPOINT_RESTORE_S
        self.max_duration_s = max_duration_s
        if self.backend is None:
            self.init_s = cold_start_s + framework_init_s
            self.usable_s = max_duration_s - self.init_s - self.restore_s
            if self.usable_s <= 0:
                raise ValueError("max_duration_s leaves no usable window")
        else:
            # VM-kind backend: provisioning replaces the cold start and
            # the duration cap disappears (no cap timer is ever armed)
            self.init_s = self.backend.provision_s + framework_init_s
            self.usable_s = math.inf
            if self.backend.spot and self.shocks is None:
                # spot preemptions ride the shock machinery: one
                # correlated kill-all shock per up-crossing of the bid
                # (an explicit ``shocks=`` wins over the synthesis)
                self.shocks = ShockModel(
                    interval_s=math.inf, kill_frac=1.0,
                    price_trace=self.backend.price_trace,
                    bid_usd_per_hr=self.backend.bid_usd_per_hr)
        self.samples = samples or workload.dataset_samples
        self.iters = max(math.ceil(self.samples / global_batch), 1)
        self.seed = seed
        self.slowdown_at_iter = slowdown_at_iter
        self.slowdown_factor = slowdown_factor
        self.on_iteration = on_iteration
        if record_trace is None:
            record_trace = True if trace_enabled is None else trace_enabled
        self.record_trace = self.trace_enabled = record_trace
        # admission offset on a shared domain clock: a workflow task whose
        # dependencies finish at t > 0 starts exactly then. wall_s stays
        # relative to the engine's own start (``_t0``); iter_times remain
        # absolute domain timestamps.
        self.start_at = max(start_at, 0.0)
        # called (with the engine) the instant every worker has finished —
        # the orchestrator's hook to resume the owning task mid-drain
        self.on_complete = on_complete
        self._t0 = 0.0

        if self.backend is not None:
            # flat per-worker compute rate and NIC: the fleet is
            # effectively homogeneous regardless of memory tiers (the
            # analytic iteration_time's exact VM regime)
            local_batch = max(global_batch // self.n, 1)
            self.base_compute_s = [
                compute_time(workload, local_batch, m,
                             gflops=self.backend.gflops_for(m))
                for m in self.mem]
        elif fleet.is_homogeneous:
            local_batch = max(global_batch // self.n, 1)
            self.base_compute_s = [compute_time(workload, local_batch, m)
                                   for m in self.mem]
        else:
            # load-aware shard placement: the global batch splits in
            # proportion to worker speed, so per-iteration compute is the
            # same on every worker (the analytic fleet estimate's exact
            # regime) — mixed fleets stop paying the barrier at the slow
            # tier's compute
            self.base_compute_s = [
                compute_time(workload, lb, m)
                for lb, m in zip(fleet_local_batches(fleet, global_batch),
                                 self.mem)]
        self.plan: CommPlan = build_plan(
            scheme, workload.grad_bytes, self.n,
            extra_upload_bytes=workload.extra_upload_bytes)
        # pipelined overlap: the overlappable phases must be a leading
        # prefix (CommPlan.pipeline guarantees it) — they execute inside
        # the compute window, the rest from index _ov_count onward
        flags = [ph.overlappable for ph in self.plan.phases]
        self._ov_count = 0
        while self._ov_count < len(flags) and flags[self._ov_count]:
            self._ov_count += 1
        if any(flags[self._ov_count:]):
            raise ValueError("overlappable phases must form a leading "
                             "prefix of the plan")
        if self.plan.pipeline_depth <= 1:
            self._ov_count = 0
        self._ov_phases = self.plan.phases[:self._ov_count]
        # per-worker function-network caps, carried as per-flow caps on the
        # (possibly cross-job shared) links; *8 as in the analytic model
        if self.backend is not None:
            self.net_cap = [self.backend.net_gbps_for(m) * 8
                            for m in self.mem]
        else:
            self.net_cap = [fn_net_gbps(m) * 8 for m in self.mem]
        self.domain = domain or ContentionDomain()
        self._job_idx = self.domain._register(self)
        self.links: Dict[str, SharedLink] = {
            "param": self.domain.link_for(param_store, "param"),
            "object": self.domain.link_for(object_store, "object"),
        }
        self.ckpt_bytes = 12.0 * workload.param_count  # params + Adam m,v

        eligible = self._coalesce_eligible()
        if coalesce is None:
            coalesce = eligible
        elif coalesce and not eligible:
            raise ValueError(
                "coalesce=True requires the lockstep-cohort regime: bsp, "
                "failure_rate=0, no shocks, unpipelined plan; a "
                "heterogeneous fleet needs record_trace=False, and "
                "straggler_sigma>0 additionally needs a bsp barrier in "
                "the plan, no cpu_s before it, and a single cohort when "
                "on_iteration is set")
        self.coalesced = coalesce
        self._workers = [_WorkerState(g) for g in self._cohorts(coalesce)]
        self._draws = _FleetDraws(self.n, self.sigma, self.failure_rate,
                                  seed, self._job_idx, self.iters)
        self._shock_rng = rng_streams.shock_stream(seed, self._job_idx)
        self._barriers: Dict[Tuple, Dict] = {}
        self._gate_waiters: List[Tuple[_WorkerState, Callable]] = []
        self._started = False
        self._stopping = False
        self._g_done = 0
        self._iter_times: List[float] = []
        self._trace: List[str] = []
        self._gb_seconds = 0.0
        self._requests = 0
        self._cap_restarts = 0
        self._failures = 0
        self._shock_events = 0
        self._backend_usd = 0.0      # per-second VM/GPU compute dollars
        self._preemptions = 0        # spot price-crossing kills
        self._spot_fallback = False  # spot died once; now billing on-demand
        self._levents = 0            # logical (cohort-weighted) transitions
        # O(1) fleet aggregates (replacing per-event fleet scans):
        # worker count per completed-iteration value, the running minimum,
        # and the not-yet-finished worker count
        self._it_hist = [0] * (self.iters + 2)
        self._it_hist[0] = self.n
        self._min_it = 0
        self._unfinished = self.n
        # union of time any gradient-sync transfer is outstanding — the
        # param store's keep-alive window (matches the analytic sync_s).
        # Accounted as closed [on, off) intervals reported to the domain
        # on 0<->1 transitions of the outstanding count.
        self._sync_active = 0
        self._sync_busy = 0.0
        self._sync_t0 = 0.0
        self._sid = id(self.param_store)
        self._wall = 0.0
        self._result: Optional[EngineResult] = None

    def _coalesce_eligible(self) -> bool:
        """Cohort batching is exact only when locally-identical workers
        provably move in lockstep between bsp barriers: no failures, no
        shocks, no second activity lane, and cohorts cut wherever the
        fleet or the plan stops being uniform. σ=0 cohorts never diverge
        at all; σ>0 cohorts diverge only inside the per-iteration
        straggler window, which ``_FanoutWindow`` simulates per member
        (see its docstring for the exactness argument)."""
        if not (self.mode == "bsp" and self.failure_rate == 0.0
                and self.shocks is None and self.plan.pipeline_depth <= 1
                and (self.backend is None or not self.backend.spot)):
            return False
        if self.sigma == 0.0:
            # a heterogeneous fleet coalesces only in perf runs: traced
            # runs keep the per-worker link decomposition observable
            return self.fleet.is_homogeneous or not self.trace_enabled
        return self._fanout_eligible()

    def _fanout_eligible(self) -> bool:
        """The σ>0 fan-out window additionally needs: traces off (the
        window emits no per-member trace lines), a bsp re-merge barrier
        to exist, no post-transfer cpu segments inside the window, and —
        when an ``on_iteration`` hook can stop the epoch mid-flight — a
        single cohort (a stop raised while another cohort's window is
        open would need per-member discard semantics)."""
        if self.trace_enabled:
            return False
        phases = self.plan.phases
        bar = next((i for i, ph in enumerate(phases) if ph.barrier_after),
                   None)
        if bar is None:
            return False
        if any(ph.cpu_s > 0.0 for ph in phases[:bar + 1]):
            return False
        if self.on_iteration is not None and len(self._cohorts(True)) > 1:
            return False
        return True

    def _cohorts(self, coalesce: bool) -> List[range]:
        if not coalesce:
            return [range(i, i + 1) for i in range(self.n)]
        # split where plan participation diverges (workers on the same
        # side of every phase's fan_in follow identical paths) and where
        # the fleet stops being locally identical: one spec and one
        # per-iteration base compute time per cohort (load-aware shard
        # placement can split a tier's batch unevenly)
        cuts = {min(ph.fan_in, self.n) for ph in self.plan.phases} | {self.n}
        specs = self.fleet.workers
        base = self.base_compute_s
        cuts.update(i for i in range(1, self.n)
                    if specs[i] != specs[i - 1] or base[i] != base[i - 1])
        groups, prev = [], 0
        for c in sorted(cuts):
            if c > prev:
                groups.append(range(prev, c))
                prev = c
        return groups

    # -- primitives ----------------------------------------------------------
    @property
    def now(self) -> float:
        return self.domain.now

    def _at(self, t: float, fn: Callable):
        self.domain.at(t, fn)

    def _tr(self, w: _WorkerState, what: str):
        if self.trace_enabled:
            stamp = f"{self.now:.6f}"
            if w.count == 1:
                self._trace.append(f"{stamp} w{w.wid} {what}")
            else:
                self._trace.extend(f"{stamp} w{wid} {what}"
                                   for wid in w.members)

    def _ckpt_put(self, w: _WorkerState):
        """Checkpoint every member's blob, namespaced by the engine's job
        index so concurrent workflow tasks sharing one ObjectStore never
        clobber each other's restart state (a private domain is j0)."""
        it = w.it
        for wid in w.members:
            self.object_store.put(f"ckpt/j{self._job_idx}/w{wid}",
                                  {"iter": it}, nbytes=self.ckpt_bytes)

    def _ckpt_restore(self, w: _WorkerState):
        for wid in w.members:
            key = f"ckpt/j{self._job_idx}/w{wid}"
            if key in self.object_store.blobs:
                self.object_store.get(key, nbytes=self.ckpt_bytes)

    def _sync_on(self):
        self._sync_active += 1
        if self._sync_active == 1:
            self.domain._sync_on(self)

    def _sync_off(self):
        self._sync_active -= 1
        if self._sync_active == 0:
            self.domain._sync_off(self)

    def _make_transfer(self, w: _WorkerState, store: str, nbytes: float,
                       requests: int, done: Callable,
                       is_sync: bool, weight: int = 1) -> _Transfer:
        """Create a transfer whose completion callback ``done`` also
        settles the sync-window counter. Claiming an activity slot is the
        caller's job (the serial path uses the worker's single slot, the
        pipeline window its transfer lane). ``nbytes`` is per member;
        ``weight`` is the cohort's member count (its claim on the link)."""
        link = self.links[store]

        def finished():
            if is_sync:
                self._sync_off()
            done()

        cap = self.net_cap[w.wid] if store == "param" else None
        tr = _Transfer(link, nbytes, link.latency_s * max(requests, 1),
                       finished, is_sync, cap_gbps=cap, weight=weight,
                       prio=self.link_priority)
        if is_sync:
            self._sync_on()
        return tr

    def _start_transfer(self, w: _WorkerState, store: str, nbytes: float,
                        requests: int, cont: Callable, is_sync: bool = False):
        def finished():
            w.activity = None
            self._levents += w.count
            cont()

        tr = self._make_transfer(w, store, nbytes, requests, finished,
                                 is_sync, weight=w.count)
        w.activity = ("transfer", tr, tr.cb)
        self._begin_setup(w, tr)

    def _begin_setup(self, w: _WorkerState, tr: _Transfer):
        link = tr.link
        tr.token += 1
        if tr.latency_left > 0:
            link.setup += 1
            self.domain.at2(self.now + tr.latency_left,
                            self.domain._setup_done, (tr, tr.token))
        else:
            link.add_flow(tr, self.now)  # resume directly into the flow
            self.domain._relink(link)

    def _do_compute(self, w: _WorkerState, duration: float, cont: Callable,
                    redo: Optional[Callable] = None):
        """``redo`` is what a correlated shock (which *loses* in-flight
        work) restarts instead of the whole iteration — e.g. a decompress
        segment inside a comm phase redoes that phase, not the compute."""
        w.activity = ("compute", cont, redo)
        w.seg_end = self.now + duration
        w.seg_gen += 1
        self.domain.at2(w.seg_end, self._compute_done, (w, w.seg_gen))

    def _compute_done(self, payload):
        w, gen = payload
        act = w.activity
        if gen != w.seg_gen or act is None or act[0] != "compute":
            return
        w.activity = None
        self._levents += w.count
        act[1]()                                 # cont

    # -- invocation lifecycle ------------------------------------------------
    def _begin_invocation(self, w: _WorkerState, overhead: float,
                          cont: Callable, resumed: bool):
        t = self.now
        recs = []
        for wid in w.members:
            rec = InvocationRecord(worker_id=wid, start=t,
                                   cold_start_s=self.init_s, resumed=resumed)
            self.platform.invocations.append(rec)
            recs.append(rec)
        w.inv_recs = recs
        w.inv_count += 1
        w.inv_gen += 1
        w.inv_cont = cont
        self._tr(w, "invoke" if not resumed else "re-invoke")
        self.domain.at2(t + overhead, self._invoke_armed, (w, w.inv_gen))

    def _invoke_armed(self, payload):
        w, gen = payload
        if gen != w.inv_gen:
            return                               # killed during init window
        # the usable window opens once init/restore completes
        cont, w.inv_cont = w.inv_cont, None
        w.cap_gen += 1
        w.cap_t = self.now + self.usable_s
        if w.cap_t != _INF:          # uncapped backends never arm the timer
            self.domain.at2(w.cap_t, self._cap_fire, (w, w.cap_gen))
        if self.backend is not None:
            # per-second billing arms when provisioning+init completes;
            # a worker killed during the provisioning gap bills nothing
            w.bill_t0 = self.now
        self._levents += w.count
        cont()

    def _close_invocation(self, w: _WorkerState):
        now = self.now
        if self.backend is not None:
            # per-second billing from the arming anchor to now: spot runs
            # integrate the price trace (engine-relative time) until the
            # first preemption flips them to the on-demand rate; no
            # GB-second or per-request fee, and no cap-splitting — so the
            # records close directly instead of through platform.finish
            if w.bill_t0 != _INF:
                if self.backend.spot and not self._spot_fallback:
                    usd = self.backend.price_trace.integral_usd(
                        w.bill_t0 - self._t0, now - self._t0) * w.count
                else:
                    usd = (now - w.bill_t0) * self.backend.usd_per_s * w.count
                self._backend_usd += usd
                self.platform.ledger.charge(
                    f"backend:{self.backend.name}", usd)
                w.bill_t0 = _INF
            for rec in w.inv_recs:
                rec.end = now
            w.inv_recs = []
            w.inv_gen += 1
            w.cap_gen += 1
            return
        for rec in w.inv_recs:
            mem = self.mem[rec.worker_id]
            for r in self.platform.finish(rec, mem, now):
                self._gb_seconds += mem / 1024.0 * (r.end - r.start)
                self._requests += 1
        w.inv_recs = []
        w.inv_gen += 1                           # stale any init-window event
        w.cap_gen += 1                           # disarm the cap timer

    def _detach_transfer(self, tr: _Transfer):
        """Remove a transfer from its link (setup or flow phase) and fix
        the sync-window counter. The transfer keeps its progress: only
        *this* flow's remaining_gb is materialized (class-tracked links
        never touch the other flows)."""
        tr.token += 1                            # cancel pending setup
        link = tr.link
        if tr.fid in link.flows:                 # mid-flow
            link.remove_flow(tr, self.now)
            self.domain._relink(link)
            tr.latency_left = 0.0
        else:
            link.setup -= 1
        if tr.is_sync:
            self._sync_off()

    def _pause_activity(self, w: _WorkerState):
        """Capture whatever the worker is doing as a resumable pending
        continuation (duration-cap preemption keeps progress: the work up
        to the checkpoint is durable)."""
        act = w.activity
        w.activity = None
        if act is None:
            return                               # waiting: barrier will defer
        kind = act[0]
        if kind == "compute":
            _, cont, redo = act
            remaining = max(w.seg_end - self.now, 0.0)
            w.seg_gen += 1
            w.pending = lambda: self._do_compute(w, remaining, cont,
                                                 redo=redo)
        elif kind == "transfer":
            _, tr, _cont = act
            self._detach_transfer(tr)
            w.pending = lambda: self._resume_transfer(w, tr)
        elif kind == "pipeline":
            _, pr = act
            pr.pause()                           # both lanes keep progress
            w.pending = pr.resume
        elif kind == "fanout":
            _, win = act
            win.pause()                          # every member keeps progress
            w.pending = win.resume

    def _reattach_transfer(self, w: _WorkerState, tr: _Transfer):
        """Put a detached transfer back on its link (keeping progress)."""
        if tr.is_sync:
            self._sync_on()
        self._begin_setup(w, tr)

    def _resume_transfer(self, w: _WorkerState, tr: _Transfer):
        w.activity = ("transfer", tr, tr.cb)
        self._reattach_transfer(w, tr)

    def _pipe_seg_done(self, payload):
        pr, gen = payload
        pr._seg_done(gen)

    def _fan_compute_done(self, payload):
        # _FanoutWindow._compute_done, inlined into the dispatch target:
        # one frame per member-compute event instead of two
        win, i, gen = payload
        if gen != win.gen:
            return
        self._levents += 1
        win.pending -= 1
        tr = win.trs[i]
        if tr is None:
            win._advance(i, 0)           # no participating phases: arrive
            return
        win.stage[i] = 0
        if tr.is_sync:
            # _sync_on inlined: only the 0 -> 1 transition leaves the fast
            # path (opens the domain keep-alive interval)
            self._sync_active += 1
            if self._sync_active == 1:
                self.domain._sync_on(self)
        if tr.latency_left > 0.0:
            tr.link.setup += 1           # setup event was pre-pushed
        else:
            link = tr.link
            link.add_flow(tr, self.now)
            self.domain._relink(link)

    def _cap_fire(self, payload):
        w, gen = payload
        if gen != w.cap_gen or w.finished or w.restarting:
            return
        self._cap_restarts += w.count
        self._tr(w, "cap-restart")
        self._pause_activity(w)
        self._close_invocation(w)
        # checkpoint out through the object store, restore on re-invoke
        self._ckpt_put(w)
        self._restart(w)

    def _fail(self, w: _WorkerState, retry: Callable):
        self._failures += w.count
        self._tr(w, "fail")
        w.activity = None
        w.seg_gen += 1
        self._close_invocation(w)
        # the dead function checkpointed nothing; the restart restores the
        # last iteration-boundary state (kept in the object store)
        self._ckpt_put(w)
        w.pending = retry
        self._restart(w)

    def _restart(self, w: _WorkerState):
        w.restarting = True

        def resume():
            self._ckpt_restore(w)
            w.restarting = False
            pending, w.pending = w.pending, None
            if callable(pending):
                pending()
            # else: worker was waiting at a barrier/gate — stays waiting

        self._begin_invocation(w, self._restart_overhead(), resume,
                               resumed=True)

    def _restart_overhead(self) -> float:
        """Re-invocation overhead: init + checkpoint restore, plus — for a
        spot backend under the "wait" policy — the unbilled wait until the
        spot price drops back below the bid (capacity is unavailable while
        the market is above it; billing re-arms only at ``_invoke_armed``)."""
        overhead = self.init_s + self.restore_s
        be = self.backend
        if (be is not None and be.spot and be.spot_policy == "wait"
                and not self._spot_fallback):
            now_rel = self.now - self._t0
            recover = be.price_trace.next_drop_below(now_rel, be.bid_usd_per_hr)
            if math.isinf(recover):
                raise ValueError("spot price never drops back below the bid; "
                                 "the wait policy cannot recover")
            overhead += max(recover - now_rel, 0.0)
        return overhead

    # -- correlated (shock) failures -----------------------------------------
    def _schedule_next_shock(self):
        if self.shocks.price_trace is not None:
            # deterministic arrivals: one shock per up-crossing of the
            # bid. A spike already in progress is skipped — the next kill
            # fires at the next genuine below->above transition.
            trace, bid = self.shocks.price_trace, self.shocks.bid_usd_per_hr
            t_rel = self.now - self._t0
            if trace.price_at(t_rel) > bid:
                t_rel = trace.next_drop_below(t_rel, bid)
                if math.isinf(t_rel):
                    return               # above the bid forever: no crossings
            t_rel = trace.next_crossing_above(t_rel, bid)
            if not math.isinf(t_rel):
                self._at(self._t0 + t_rel, self._shock_fire)
            return
        dt = float(self._shock_rng.exponential(self.shocks.interval_s))
        self._at(self.now + max(dt, 1e-9), self._shock_fire)

    def _shock_fire(self):
        """One shared shock: every eligible in-flight worker of the target
        tier dies with probability ``kill_frac`` — a correlated burst, not
        n independent coin flips spread over iterations. The fleet's kill
        coins are one vectorized draw per shock. Price-driven shocks
        (``ShockModel.price_trace``) additionally count as spot
        preemptions; under the backend's "fallback" spot policy the first
        one flips billing to on-demand and ends the preemption process."""
        if self._stopping or self._unfinished == 0 or self._spot_fallback:
            return                               # epoch over: stop the process
        us = self._shock_rng.random_sample(self.n)
        killed = 0
        for w in self._workers:      # singleton cohorts (shocks ⇒ uncoalesced)
            tier = self.fleet.workers[w.wid].tier
            if self.shocks.tier is not None and tier != self.shocks.tier:
                continue
            if us[w.wid] < self.shocks.kill_frac and self._shock_kill(w):
                killed += w.count
        if killed:
            self._shock_events += 1
            if self.shocks.price_trace is not None:
                self._preemptions += killed
                be = self.backend
                if be is not None and be.spot and be.spot_policy == "fallback":
                    # the kill itself billed at the spot price (settled in
                    # _close_invocation before this flag flips); everything
                    # after re-arms at the on-demand rate, preemption-free
                    self._spot_fallback = True
                    return
        self._schedule_next_shock()

    def _shock_kill(self, w: _WorkerState) -> bool:
        """Kill one worker mid-flight: unlike a duration-cap preemption the
        in-flight work is *lost* — compute restarts from the iteration
        boundary, a partial transfer re-sends from byte 0."""
        if w.finished or w.restarting:
            return False                         # nothing running to kill
        self._failures += w.count
        self._tr(w, "shock-fail")
        act = w.activity
        w.activity = None
        if act is None:
            if w.inv_cont is not None:
                # died inside the init window: redo the owed continuation
                w.pending = w.inv_cont
            # else: waiting at a barrier/gate — the release will deliver
        elif act[0] == "compute":
            w.seg_gen += 1
            redo = act[2]
            w.pending = redo if redo is not None else (
                lambda: self._compute_phase(w))
        elif act[0] == "pipeline":               # both lanes are lost
            act[1].abort()
            w.pending = lambda: self._compute_phase(w)
        else:                                    # transfer: bytes are lost
            _, tr, _cont = act
            self._detach_transfer(tr)
            tr.remaining_gb = tr.total_gb
            tr.latency_left = tr.setup_latency_s
            w.pending = lambda: self._resume_transfer(w, tr)
        self._close_invocation(w)
        self._ckpt_put(w)
        self._restart(w)
        return True

    # -- synchronization -----------------------------------------------------
    def _barrier(self, key: Tuple, w: _WorkerState, cont: Callable):
        if self._stopping:
            # epoch aborted at the last completed iteration's checkpoint:
            # the in-flight iteration is discarded, nobody else will arrive
            return self._finish_worker(w)
        b = self._barriers.setdefault(key, {"count": 0, "waiters": []})
        b["count"] += w.count
        w.activity = None
        if b["count"] >= self.n:
            del self._barriers[key]
            self._tr(w, f"barrier-release {key[0]}:{key[1]}")
            for ww, wcont in b["waiters"]:
                self._release(ww, wcont)
            self._release(w, cont)
        else:
            b["waiters"].append((w, cont))

    def _release(self, w: _WorkerState, cont: Callable):
        if w.restarting:
            w.pending = cont                     # deliver after re-invoke
        else:
            cont()

    def _gate_ok(self, w: _WorkerState) -> bool:
        if self.mode == "async" or self.staleness is None:
            return True
        return w.it - self._min_it <= self.staleness

    def _poke_gate(self):
        if not self._gate_waiters:
            return
        ready, self._gate_waiters = self._gate_waiters, []
        for w, cont in ready:
            if self._stopping or self._gate_ok(w):
                self._release(w, cont)
            else:
                self._gate_waiters.append((w, cont))

    # -- worker state machine ------------------------------------------------
    def _start_worker(self, w: _WorkerState):
        shard_bytes = self.w.sample_bytes * self.samples / self.n

        def fetch():
            self._tr(w, "data-fetch")
            self._start_transfer(w, "object", shard_bytes, 1,
                                 lambda: self._begin_iteration(w))

        # cap window is armed after init; the epoch's data fetch rides
        # before the first compute, as in the analytic model
        self._begin_invocation(w, self.init_s, fetch, resumed=False)

    def _begin_iteration(self, w: _WorkerState):
        if self._stopping or w.it >= self.iters:
            return self._finish_worker(w)
        if self.mode == "ssp" and not self._gate_ok(w):
            w.activity = None
            self._gate_waiters.append((w, lambda: self._begin_iteration(w)))
            return
        self._compute_phase(w)

    def _compute_phase(self, w: _WorkerState):
        if self.coalesced and self.sigma > 0.0:
            # σ>0 cohort: members diverge here and re-merge at the first
            # bsp barrier — the fan-out window runs that stretch per
            # member with one bulk event push (eligibility was proven at
            # construction)
            win = w.fan
            if win is None:
                win = w.fan = _FanoutWindow(self, w)
            return win.start()
        k = w.draws
        w.draws = k + 1
        factor = self._draws.factor(w.wid, k)
        if (self.slowdown_at_iter is not None
                and w.it >= self.slowdown_at_iter):
            factor *= self.slowdown_factor
        d = self.base_compute_s[w.wid] * factor
        if self.failure_rate > 0.0:
            failed, frac = self._draws.failed(w.wid, k)
            if failed:
                self._do_compute(w, d * frac,
                                 lambda: self._fail(
                                     w, lambda: self._compute_phase(w)))
                return
        if self.trace_enabled:
            self._tr(w, f"compute it{w.it}")
        if self._ov_count:
            # pipelined plan: compute and the overlappable uploads run
            # as two concurrent lanes inside one window
            return _PipelineRun(self, w, d).start()
        self._do_compute(w, d, lambda: self._comm_phase(w, 0))

    def _pipeline_done(self, w: _WorkerState):
        """Both lanes of the overlap window drained: run the deferred
        barriers of the overlappable phases (bsp), then the sequential
        remainder of the plan."""
        if self._stopping:
            return self._finish_worker(w)        # discard partial iteration
        self._chain_ov_barriers(w, 0)

    def _chain_ov_barriers(self, w: _WorkerState, i: int):
        if i >= self._ov_count:
            return self._comm_phase(w, self._ov_count)
        ph = self.plan.phases[i]
        nxt = lambda: self._chain_ov_barriers(w, i + 1)  # noqa: E731
        if self.mode == "bsp" and ph.barrier_after:
            self._barrier((ph.name, w.it), w, nxt)
        else:
            nxt()

    def _comm_phase(self, w: _WorkerState, pi: int):
        """Execute the plan's phases generically: workers ``0..fan_in-1``
        participate in phase ``pi`` (aggregators are relabeled to the
        lowest ids); the rest skip straight to its barrier. A phase with
        ``cpu_s`` (decompressing a sparse payload) computes after its
        transfer, off the store link. In bsp, ``barrier_after`` joins all
        n workers; ssp/async drop the joins."""
        if self._stopping:
            return self._finish_worker(w)        # discard partial iteration
        if pi >= len(self.plan.phases):
            return self._iteration_done(w)
        ph = self.plan.phases[pi]

        def advance():
            if self.mode == "bsp" and ph.barrier_after:
                self._barrier((ph.name, w.it), w,
                              lambda: self._comm_phase(w, pi + 1))
            else:
                self._comm_phase(w, pi + 1)

        if w.wid >= ph.fan_in:
            return advance()                     # not a participant

        def done():
            if ph.cpu_s > 0:
                # a shock mid-decompress redoes this phase (payload lost),
                # not the iteration's compute
                self._do_compute(w, ph.cpu_s, advance,
                                 redo=lambda: self._comm_phase(w, pi))
            else:
                advance()

        # only param-store phases hold the Redis container: an
        # object-store plan (ps_s3) accrues no keep-alive billing
        self._start_transfer(w, ph.store, ph.nbytes, ph.requests, done,
                             is_sync=(ph.store == "param"))

    def _iteration_done(self, w: _WorkerState):
        it0 = w.it
        w.it = it0 + 1
        if self.trace_enabled:
            self._tr(w, f"step it{it0}")
        self._levents += w.count
        hist = self._it_hist
        hist[it0] -= w.count
        hist[it0 + 1] += w.count
        if it0 == self._min_it and hist[it0] == 0:
            m = it0
            while m < self.iters and hist[m] == 0:
                m += 1
            self._min_it = m
        lo = self._min_it
        while self._g_done < lo:
            self._g_done += 1
            prev = self._iter_times[-1] if self._iter_times else None
            self._iter_times.append(self.now)
            if self.on_iteration is not None:
                dt = (self.now - prev) if prev is not None else 0.0
                if self.on_iteration(self._g_done, self.now, dt):
                    self._stopping = True
                    self._tr(w, "stop-requested")
                    self._flush_barriers()
        self._poke_gate()
        self._begin_iteration(w)

    def _flush_barriers(self):
        """On an early stop, peers parked at a barrier would wait forever
        (the stopping workers never arrive) — release them to finish."""
        barriers, self._barriers = self._barriers, {}
        for b in barriers.values():
            for ww, _cont in b["waiters"]:
                self._release(ww, lambda ww=ww: self._finish_worker(ww))

    def _finish_worker(self, w: _WorkerState):
        if w.finished:
            return
        w.finished = True
        if self._stopping:
            self._ckpt_put(w)
        self._close_invocation(w)
        self._tr(w, "finish")
        self._levents += w.count
        self._unfinished -= w.count
        if self._unfinished == 0:
            self._wall = self.now    # stale timer events may pop later
            if self.on_complete is not None:
                self.on_complete(self)

    # -- run -----------------------------------------------------------------
    def _start(self):
        if self._started:
            return
        self._started = True
        self._t0 = self.now
        for w in self._workers:
            self._start_worker(w)
        if self.shocks is not None:
            self._schedule_next_shock()

    def _check_complete(self):
        unfinished = [wid for w in self._workers if not w.finished
                      for wid in w.members]
        if unfinished:
            raise RuntimeError(f"event engine deadlock: workers {unfinished} "
                               f"never finished (mode={self.mode})")

    def run(self) -> EngineResult:
        """Run this engine's domain to completion and return this engine's
        result. (In a shared domain this runs *every* registered engine —
        the clock is shared; prefer ``domain.run()`` + ``engine.result()``
        for multi-job setups.)"""
        self.domain.run()
        return self.result()

    def result(self) -> EngineResult:
        if self._result is not None:
            return self._result
        self._check_complete()
        sync_s = self._sync_busy
        # billing basis: this job's share of the store's keep-alive union
        # (identical to sync_s unless the store is shared across jobs)
        billed_s = self.domain.store_keep_alive_share(self)
        self.param_store.keep_alive(billed_s)
        lambda_usd = (self._gb_seconds * LAMBDA_GB_SECOND
                      + self._requests * LAMBDA_PER_REQUEST)
        store_hourly = (self.param_store.vcpus * ECS_VCPU_HOUR
                        + self.param_store.memory_gb * ECS_GB_HOUR)
        n_objects = max(math.ceil(self.w.sample_bytes * self.samples
                                  / DATA_OBJECT_BYTES), 1)
        store_usd = (billed_s / 3600.0 * store_hourly
                     + n_objects * S3_GET_PER_1K / 1000.0 * self.n)
        self._result = EngineResult(
            wall_s=max(self._wall - self._t0, 0.0),
            lambda_usd=lambda_usd, store_usd=store_usd,
            iters_done=self._g_done,
            samples_done=min(self._g_done * self.global_batch, self.samples),
            sync_s=sync_s, store_billed_s=billed_s,
            restarts=self._cap_restarts,
            failures=self._failures, invocations=self._requests,
            iter_times=self._iter_times, stopped_early=self._stopping,
            trace=self._trace, shock_events=self._shock_events,
            sim_events=self._levents, backend_usd=self._backend_usd,
            preemptions=self._preemptions)
        return self._result


@dataclasses.dataclass
class ServingResult:
    """What one event-engine serving job produced."""
    wall_s: float                # first arrival admitted -> last batch done
    lambda_usd: float
    store_usd: float
    requests: int                # inference requests served
    batches: int                 # function invocations (one per batch)
    mean_batch: float
    p50_s: float
    p99_s: float
    slo_s: Optional[float]
    slo_violations: int          # requests whose latency exceeded slo_s
    cold_starts: int
    warm_hits: int               # batches served by a reused instance
    peak_instances: int
    sync_s: float                # own param-store fetch-outstanding window
    store_billed_s: float        # keep-alive share billed (cross-job union)
    sim_events: int

    @property
    def cost_usd(self) -> float:
        return self.lambda_usd + self.store_usd

    @property
    def cost_per_1k(self) -> float:
        return (self.cost_usd / self.requests * 1000.0
                if self.requests else 0.0)


class _ServeInstance:
    """One serverless serving function: a worker state machine of the
    serving fleet. States: ``cold`` (booting + fetching code/model),
    ``idle`` (warm, waiting for a batch, expires after keep_warm_s),
    ``busy`` (executing a batch), ``fetch`` (re-pulling the current model
    mid-flight — continuous deployment)."""

    __slots__ = ("iid", "state", "busy_until", "spin_t", "last_fetch",
                 "served", "expiry_gen")

    def __init__(self, iid: int, now: float, ready_est: float):
        self.iid = iid
        self.state = "cold"
        self.busy_until = ready_est  # prediction while cold/fetch, exact busy
        self.spin_t = now
        self.last_fetch = now
        self.served = 0
        self.expiry_gen = 0


class ServingJob:
    """Inference traffic as a first-class event-engine job.

    An autoscaled serverless serving fleet drains one arrival stream
    under a :class:`repro_torch.serving.ServePolicy` (same SLO-driven dynamic
    batching semantics as ``repro_torch.serving.simulate``, which this job
    reproduces exactly in the single-instance zero-cold-start limit —
    tested). Each function instance is a worker state machine; admission
    is cold-start-aware: a queued batch either waits for the earliest
    busy/cold instance or pays a fresh cold start, whichever is
    predicted faster.

    Registered into a ``ContentionDomain`` exactly like an
    ``EventEngine`` (duck-typed engine interface), so serving co-runs
    with training on one clock: cold starts fetch ``code_bytes`` from
    the ObjectStore and ``model_bytes`` from the ParamStore over the
    *shared* links — "serve the current model" genuinely contends with
    "train the next one" — and the model fetches hold the param store's
    keep-alive window (billed as this job's share of the cross-job
    union). With ``refresh_every_s`` set, warm instances re-pull the
    model at that cadence: continuous deployment serves the current
    weights, at a steady bandwidth price. ``link_priority`` raises the
    serving fetches' water-filling priority on the shared links, which
    bounds how much a training bulk-sync can inflate serving latency.

    Billing mirrors Lambda and lands on the shared platform ledger as it
    accrues: one request per batch plus GB-seconds of execution (and of
    model refreshes); the cold-start init window itself is unbilled, but
    its code fetch pays an S3 GET. ``result()`` attributes this job's
    total to ``ledger.job_usd[job]``."""

    def __init__(self, policy, arrivals: np.ndarray,
                 flops_per_request: float, param_store: ParamStore,
                 object_store: ObjectStore, *,
                 domain: Optional[ContentionDomain] = None,
                 platform: Optional[ServerlessPlatform] = None,
                 model_bytes: float = 0.0, code_bytes: float = 0.0,
                 cold_start_s: float = 1.0, keep_warm_s: float = 60.0,
                 max_instances: int = 64,
                 refresh_every_s: Optional[float] = None,
                 link_priority: float = 1.0, slo_s: Optional[float] = None,
                 job: str = "serving", start_at: float = 0.0,
                 on_complete: Optional[Callable] = None):
        if max_instances < 1:
            raise ValueError("max_instances must be >= 1")
        from repro_torch.serving.batcher import exec_time  # deferred: no cycle
        self._exec_time = exec_time
        self.policy = policy
        self.arrivals = np.asarray(arrivals, dtype=float)
        if len(self.arrivals) > 1 and np.any(np.diff(self.arrivals) < 0):
            raise ValueError("arrivals must be sorted")
        self.flops_per_request = flops_per_request
        self.param_store = param_store
        self.object_store = object_store
        self.platform = platform
        self.model_bytes = model_bytes
        self.code_bytes = code_bytes
        self.cold_start_s = cold_start_s
        self.keep_warm_s = keep_warm_s
        self.max_instances = max_instances
        self.refresh_every_s = refresh_every_s
        self.link_priority = link_priority
        self.slo_s = slo_s
        self.job = job
        self.start_at = max(start_at, 0.0)
        self.on_complete = on_complete
        self.mem_gb = policy.memory_mb / 1024.0
        self.net_cap = fn_net_gbps(policy.memory_mb) * 8
        # full-batch execution estimate, used by the admission predictor
        self._exec_full = exec_time(flops_per_request, policy.max_batch,
                                    policy.memory_mb)
        self.domain = domain or ContentionDomain()
        self._job_idx = self.domain._register(self)
        self.links: Dict[str, SharedLink] = {
            "param": self.domain.link_for(param_store, "param"),
            "object": self.domain.link_for(object_store, "object"),
        }
        self.instances: List[_ServeInstance] = []
        self._iids = itertools.count()
        self._next = 0           # first unserved request index
        self._delivered = 0      # requests arrived so far
        self._timer_idx = -1     # oldest-request index the timer is armed for
        self._timer_gen = 0
        self._batch_log: List[Tuple[int, int, float]] = []  # (i, j, done_t)
        self._gb_seconds = 0.0
        self._requests = 0       # invocations billed (one per batch)
        self._cold_starts = 0
        self._warm_hits = 0
        self._peak = 0
        self._levents = 0
        self._started = False
        self._done = False
        self._t0 = 0.0
        self._wall = 0.0
        # ContentionDomain engine interface (sync-union accounting)
        self._sync_active = 0
        self._sync_busy = 0.0
        self._sync_t0 = 0.0
        self._sid = id(self.param_store)
        self._result: Optional[ServingResult] = None

    # -- primitives ----------------------------------------------------------
    @property
    def now(self) -> float:
        return self.domain.now

    def _sync_on(self):
        self._sync_active += 1
        if self._sync_active == 1:
            self.domain._sync_on(self)

    def _sync_off(self):
        self._sync_active -= 1
        if self._sync_active == 0:
            self.domain._sync_off(self)

    def _transfer(self, store: str, nbytes: float, cont: Callable,
                  is_sync: bool):
        """Open one serving-priority flow on a (possibly shared) store
        link; ``cont`` runs when it drains."""
        link = self.links[store]

        def finished():
            if is_sync:
                self._sync_off()
            cont()

        cap = self.net_cap if store == "param" else None
        tr = _Transfer(link, nbytes, link.latency_s, finished, is_sync,
                       cap_gbps=cap, prio=self.link_priority)
        if is_sync:
            self._sync_on()
        if tr.latency_left > 0:
            link.setup += 1
            self.domain.at2(self.now + tr.latency_left,
                            self.domain._setup_done, (tr, tr.token))
        else:
            link.add_flow(tr, self.now)
            self.domain._relink(link)

    def _bill(self, duration_s: float, request: bool):
        """Accrue GB-seconds (and optionally one Lambda request) both on
        this job's counters and — live, so co-running jobs see one shared
        bill — on the platform ledger."""
        self._gb_seconds += self.mem_gb * duration_s
        if request:
            self._requests += 1
        if self.platform is not None:
            led = self.platform.ledger
            led.gb_seconds += self.mem_gb * duration_s
            if request:
                led.requests += 1

    # -- arrival stream ------------------------------------------------------
    def _start(self):
        if self._started:
            return
        self._started = True
        self._t0 = self.now
        if len(self.arrivals) == 0:
            return self._finish()
        # bulk-push the whole arrival slab in one calendar insert rather
        # than chaining arrival k -> arrival k+1 one event at a time
        t0, arrive = self._t0, self._arrive
        self.domain.at2_bulk([(t0 + a, arrive, k)
                              for k, a in enumerate(self.arrivals.tolist())])

    def _arrive(self, k: int):
        self._delivered = k + 1
        self._levents += 1
        self._dispatch()

    # -- dynamic batching + admission ----------------------------------------
    def _dispatch(self):
        """Launch batches while the policy says go: a batch launches when
        the queue holds ``max_batch`` requests, the oldest has waited
        ``timeout_s`` since *arrival*, or the stream is exhausted — the
        exact (fixed) ``simulate`` semantics, with batch membership
        decided at launch."""
        pol = self.policy
        n = len(self.arrivals)
        while True:
            qlen = self._delivered - self._next
            if qlen == 0:
                return
            oldest = self._t0 + self.arrivals[self._next]
            full = qlen >= pol.max_batch
            exhausted = self._delivered == n
            overdue = self.now >= oldest + pol.timeout_s - 1e-12
            if not (full or overdue or exhausted):
                self._arm_timer(oldest + pol.timeout_s)
                return
            inst = self._acquire()
            if inst is None:
                return           # instance-ready/free events re-dispatch
            take = min(qlen, pol.max_batch)
            self._launch_batch(inst, self._next, self._next + take)
            self._next += take

    def _arm_timer(self, deadline: float):
        if self._timer_idx == self._next:
            return               # already armed for this oldest request
        self._timer_idx = self._next
        self._timer_gen += 1
        self.domain.at2(deadline, self._timeout_fire, self._timer_gen)

    def _timeout_fire(self, gen: int):
        if gen != self._timer_gen:
            return
        self._timer_idx = -1
        self._dispatch()

    def _acquire(self) -> Optional[_ServeInstance]:
        """A warm idle instance if one exists; otherwise the cold-start-
        aware admission decision: scale out only when a fresh cold start
        is predicted ready before the current fleet can reach the
        *backlog* — the earliest instance-free time plus the pending
        batches already queued ahead, drained fleet-wide (comparing
        against the earliest free time alone would never scale out: one
        busy instance always frees before a cold start lands, while the
        queue grows without bound)."""
        for inst in self.instances:
            if inst.state == "idle":
                return inst
        if len(self.instances) < self.max_instances:
            t_cold = self.now + self.cold_start_s + self._fetch_est()
            m = len(self.instances)
            if m:
                pending = -(-(self._delivered - self._next)
                            // self.policy.max_batch)
                t_wait = (min(inst.busy_until for inst in self.instances)
                          + (pending - 1) * self._exec_full / m)
            else:
                t_wait = math.inf
            if t_cold < t_wait:
                self._spin_up()
        return None

    def _fetch_est(self) -> float:
        """Uncontended estimate of the cold-start artifact fetches (the
        admission policy's prediction — actual fetches ride the shared
        links and may be slower)."""
        est = 0.0
        if self.code_bytes > 0:
            lnk = self.links["object"]
            est += lnk.latency_s + self.code_bytes / 1e9 / lnk.per_stream_gbps
        if self.model_bytes > 0:
            lnk = self.links["param"]
            bw = min(self.net_cap, lnk.per_stream_gbps)
            est += lnk.latency_s + self.model_bytes / 1e9 / bw
        return est

    # -- instance lifecycle --------------------------------------------------
    def _spin_up(self):
        inst = _ServeInstance(next(self._iids), self.now,
                              self.now + self.cold_start_s
                              + self._fetch_est())
        self.instances.append(inst)
        self._cold_starts += 1
        self._levents += 1
        self._peak = max(self._peak, len(self.instances))

        def after_model():
            inst.last_fetch = self.now
            self._instance_idle(inst)
            self._dispatch()

        def after_code():
            if self.model_bytes > 0:
                self._transfer("param", self.model_bytes, after_model,
                               is_sync=True)
            else:
                after_model()

        def boot_done():
            if self.code_bytes > 0:
                # the GET request itself is billed in result(); the bytes
                # ride the shared object link here
                self._transfer("object", self.code_bytes, after_code,
                               is_sync=False)
            else:
                after_code()

        self.domain.at(self.now + self.cold_start_s, boot_done)

    def _instance_idle(self, inst: _ServeInstance):
        inst.state = "idle"
        inst.busy_until = self.now
        inst.expiry_gen += 1
        if math.isfinite(self.keep_warm_s):
            self.domain.at2(self.now + self.keep_warm_s, self._expire_fire,
                            (inst, inst.expiry_gen))
        self._maybe_finish()

    def _expire_fire(self, payload):
        inst, gen = payload
        if gen != inst.expiry_gen or inst.state != "idle":
            return
        # keep-warm window elapsed unused: the platform reclaims it
        # (scale-in; idle time is the provider's cost, not billed)
        self.instances.remove(inst)
        self._levents += 1

    def _launch_batch(self, inst: _ServeInstance, i: int, j: int):
        batch = j - i
        dt = self._exec_time(self.flops_per_request, batch,
                             self.policy.memory_mb)
        if inst.served > 0:
            self._warm_hits += 1
        inst.served += 1
        inst.state = "busy"
        inst.expiry_gen += 1
        inst.busy_until = self.now + dt
        self._bill(dt, request=True)
        self._levents += batch
        self.domain.at2(self.now + dt, self._batch_done, (inst, i, j))

    def _batch_done(self, payload):
        inst, i, j = payload
        self._batch_log.append((i, j, self.now))
        if (self.refresh_every_s is not None and self.model_bytes > 0
                and self.now - inst.last_fetch >= self.refresh_every_s):
            # continuous deployment: re-pull the current weights before
            # taking more traffic; the function keeps billing while it
            # downloads, and the fetch contends on the shared param link
            inst.state = "fetch"
            inst.busy_until = self.now + self._fetch_est()
            t_fetch0 = self.now

            def refreshed():
                inst.last_fetch = self.now
                self._bill(self.now - t_fetch0, request=False)
                self._instance_idle(inst)
                self._dispatch()

            self._transfer("param", self.model_bytes, refreshed,
                           is_sync=True)
        else:
            self._instance_idle(inst)
        self._dispatch()

    def _maybe_finish(self):
        n = len(self.arrivals)
        if self._done or self._delivered < n or self._next < n:
            return
        if any(inst.state in ("busy", "cold", "fetch")
               for inst in self.instances):
            return
        self._finish()

    def _finish(self):
        self._done = True
        self._wall = self.now
        if self.on_complete is not None:
            self.on_complete(self)

    # -- results -------------------------------------------------------------
    def _check_complete(self):
        if not self._done:
            raise RuntimeError(
                f"serving job deadlock: {self._delivered - self._next} "
                f"queued of {len(self.arrivals)} requests never served")

    def run(self) -> ServingResult:
        """Run this job's domain to completion and return this job's
        result (prefer ``domain.run()`` + ``job.result()`` when sharing
        a domain)."""
        self.domain.run()
        return self.result()

    def result(self) -> ServingResult:
        if self._result is not None:
            return self._result
        self._check_complete()
        if self._batch_log:
            lat = np.concatenate([
                done - (self._t0 + self.arrivals[i:j])
                for i, j, done in self._batch_log])
        else:
            lat = np.zeros(1)
        billed_s = self.domain.store_keep_alive_share(self)
        self.param_store.keep_alive(billed_s)
        lambda_usd = (self._gb_seconds * LAMBDA_GB_SECOND
                      + self._requests * LAMBDA_PER_REQUEST)
        store_hourly = (self.param_store.vcpus * ECS_VCPU_HOUR
                        + self.param_store.memory_gb * ECS_GB_HOUR)
        gets = self._cold_starts if self.code_bytes > 0 else 0
        store_usd = (billed_s / 3600.0 * store_hourly
                     + gets * S3_GET_PER_1K / 1000.0)
        requests = sum(j - i for i, j, _ in self._batch_log)
        batches = len(self._batch_log)
        violations = (int(np.sum(lat > self.slo_s))
                      if self.slo_s is not None and requests else 0)
        self._result = ServingResult(
            wall_s=max(self._wall - self._t0, 0.0),
            lambda_usd=lambda_usd, store_usd=store_usd,
            requests=requests, batches=batches,
            mean_batch=requests / batches if batches else 0.0,
            p50_s=float(np.percentile(lat, 50)) if requests else 0.0,
            p99_s=float(np.percentile(lat, 99)) if requests else 0.0,
            slo_s=self.slo_s, slo_violations=violations,
            cold_starts=self._cold_starts, warm_hits=self._warm_hits,
            peak_instances=self._peak, sync_s=self._sync_busy,
            store_billed_s=billed_s, sim_events=self._levents)
        if self.platform is not None:
            self.platform.ledger.charge("store", store_usd)
            self.platform.ledger.attribute(self.job, self._result.cost_usd)
        return self._result
