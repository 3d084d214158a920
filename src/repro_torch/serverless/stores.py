"""Hybrid storage models (paper Section 4.3).

 - ``ObjectStore``: S3-like. High per-request latency, wide aggregate
   bandwidth, priced per-request + per-GB-month. Holds code + training data
   (infrequent access).
 - ``ParamStore``: Redis-on-ECS-like. Sub-millisecond latency, node-limited
   bandwidth, priced per container-hour while alive. Holds per-iteration
   gradients/shards (frequent access). SMLT keeps it alive only during
   synchronization phases.

Both can also hold real payloads (tensors, kept by reference) so the
*semantic* training path (real PyTorch workers) uses the same interfaces as
the analytic simulator. A copy of the JAX package's ``serverless/stores.py``
plus ``ParamStore.drop``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Dict, List, Optional, Tuple

# Pricing (us-east-1, 2022)
S3_PUT_PER_1K = 0.005
S3_GET_PER_1K = 0.0004
S3_GB_MONTH = 0.023
ECS_VCPU_HOUR = 0.04048
ECS_GB_HOUR = 0.004445


@dataclasses.dataclass
class TransferStats:
    puts: int = 0
    gets: int = 0
    bytes_in: float = 0.0
    bytes_out: float = 0.0


class _FlowClass:
    """One ``(cap, prio)`` equivalence class of flows on a SharedLink.

    Water-filling assigns every member stream of a class the same rate
    (flows with equal cap and priority are interchangeable claimants), so
    the class — not the flow — is the unit of incremental accounting: a
    single virtual-work integral ``served`` (GB delivered per member
    stream since the class was created) advances at ``rate`` per second,
    and a flow added at served-level S with R GB left drains when
    ``served`` reaches its target S + R. Targets live in a lazy-deletion
    min-heap, making membership changes O(log K-ish) with no per-flow
    touch-up on clock advances.

    ``pred_t``/``pred_id`` belong to the event engine's lazy completion
    re-prediction: the earliest pending ``CalendarQueue`` prediction for
    this class and its staleness stamp (see ``ContentionDomain._relink``).
    """

    __slots__ = ("cap", "prio", "n", "w", "served", "rate", "target",
                 "heap", "pred_t", "pred_id")

    def __init__(self, cap: float, prio: float):
        self.cap = cap
        self.prio = prio
        self.n = 0                    # flows currently in the class
        self.w = 0                    # member streams (sum of flow weights)
        self.served = 0.0             # GB delivered per member stream
        self.rate = 0.0               # current per-member rate (GB/s)
        self.target: Dict[int, float] = {}   # fid -> drain served-level
        self.heap: List[Tuple[float, int]] = []
        self.pred_t = math.inf        # earliest pending drain prediction
        self.pred_id = 0              # invalidates stale predictions


def _class_order(c: _FlowClass) -> Tuple[float, float, float]:
    """Water-filling visit order: ascending cap-to-claim ratio (a class
    whose cap binds below its proportional share releases the excess to
    everyone behind it). The (cap, prio) tail makes the order total."""
    return (c.cap / c.prio, c.cap, c.prio)


class SharedLink:
    """Water-filling processor-sharing bandwidth resource for the event
    engine.

    The analytic model divides a store's aggregate bandwidth by a static
    ``concurrent=n``; here, transfers that *actually overlap in time*
    share the link by max-min fair water-filling: flows are offered equal
    shares of the aggregate, a flow capped below its share (its own
    ``cap_gbps``, defaulting to the link's ``per_stream_gbps``) keeps only
    its cap, and the share it cannot use is redistributed across the
    remaining flows — the link is never idle while any uncapped flow is
    backlogged, and total throughput never exceeds
    ``min(aggregate, sum of caps)``. Rates are re-evaluated whenever a
    flow joins or leaves. With identical caps this reduces to the classic
    ``min(cap, aggregate / k)`` processor sharing. One link may be shared
    by *several* engines in a ``ContentionDomain`` — cross-job transfers
    then slow each other by their actual overlap. (Keep-alive billing is
    the engine's job: it tracks the union of time gradient-sync transfers
    are outstanding, across links.)

    Flows added through ``add_flow`` are grouped into K equivalence
    **classes** keyed by ``(cap, prio)`` — K = tiers x priorities, small
    and bounded — and water-filling runs over the classes instead of the
    n flows. Each class keeps its own served-integral and lazy-deletion
    drain heap, so ``add_flow``/``remove_flow``/``take_drained`` are
    O(log K) and a clock advance is O(K) regardless of flow count: mixed
    -cap fleets and priority-carrying serving fetches ride the same
    incremental path a uniform fleet does. Flows injected directly into
    ``flows`` (tests, external tools) fall back to materialized per-flow
    accounting; ``incremental=False`` forces that fallback everywhere
    (the property-test reference)."""

    def __init__(self, name: str, aggregate_gbps: float,
                 per_stream_gbps: float, latency_s: float,
                 incremental: bool = True):
        self.name = name
        self.aggregate_gbps = aggregate_gbps
        self.per_stream_gbps = per_stream_gbps
        self.latency_s = latency_s
        self.incremental = incremental
        self.flows: Dict[int, Any] = {}      # fid -> transfer (remaining_gb)
        self.setup = 0                       # transfers in the latency phase
        self.generation = 0                  # bumped on any flow-set change
        self.last_t = 0.0
        self._rates_key = None               # (generation, len) of the cache
        self._rates: Dict[int, float] = {}
        self.classes: Dict[Tuple[float, float], _FlowClass] = {}
        self._active = 0                     # classes with n > 0
        self._ntracked = 0                   # flows owned by a class
        self._total_w = 0                    # member streams, all classes
        self.cascade = None                  # sole fan-out window (engine opt)

    def _cap(self, tr: Any) -> float:
        return getattr(tr, "cap_gbps", None) or self.per_stream_gbps

    @staticmethod
    def _prio(tr: Any) -> float:
        """Water-filling priority weight: a flow with ``prio`` p claims p
        equal shares per member stream (default 1.0 — plain max-min).
        Lets latency-critical serving fetches keep a guaranteed fraction
        of a link they share with training bulk syncs."""
        return getattr(tr, "prio", 1.0) or 1.0

    def _tracked(self) -> bool:
        """True while every current flow was added via ``add_flow`` — the
        O(K) class accounting is valid. Flows injected directly into
        ``flows`` (tests, external tools) simply fall back to the
        materialized per-flow path."""
        return self._ntracked == len(self.flows) > 0

    # -- incremental flow-set maintenance (engine fast path) -----------------
    def add_flow(self, tr: Any, now: Optional[float] = None):
        """Register a flow in its ``(cap, prio)`` class. ``tr.remaining_gb``
        must be up to date (it is captured into the drain target here).
        Passing ``now`` advances the link first, so the capture is taken
        at the current instant. Returns the flow's class when the
        incremental path took it (None on the materialized fallback) —
        callers use it to re-key only that class's drain prediction."""
        if now is not None and now != self.last_t:
            if self._active == 1 and self._ntracked == len(self.flows):
                # single-class advance inline (identical arithmetic to
                # progress(); the one active class is found by scan, K≤2)
                for c in self.classes.values():
                    if c.n:
                        c.served += c.rate * (now - self.last_t)
                        break
                self.last_t = now
            else:
                self.progress(now)
        flows = self.flows
        was_tracked = not flows or self._ntracked == len(flows)
        fid = tr.fid
        flows[fid] = tr
        self.generation += 1
        w = tr.weight
        self._total_w += w
        if not (self.incremental and was_tracked):
            return                           # materialized fallback
        key = (tr.cap_gbps or self.per_stream_gbps, tr.prio or 1.0)
        c = self.classes.get(key)
        if c is None:
            c = self.classes[key] = _FlowClass(*key)
        if c.n == 0:
            self._active += 1
        c.n += 1
        c.w += w
        tgt = c.served + tr.remaining_gb
        c.target[fid] = tgt
        heapq.heappush(c.heap, (tgt, fid))
        self._ntracked += 1
        if self._active == 1:
            # single-class refresh inline: c is the one active class and
            # this is the classic processor-sharing formula (identical
            # arithmetic to _refresh_rates)
            c.rate = min(c.cap, self.aggregate_gbps / self._total_w)
        else:
            self._refresh_rates()
        return c

    def remove_flow(self, tr: Any, now: Optional[float] = None):
        """Drop a flow, materializing *its own* ``remaining_gb`` (pause /
        checkpoint paths read it). The rest of the flow set is untouched —
        no whole-set materialization."""
        if now is not None and now != self.last_t:
            self.progress(now)
        fid = tr.fid
        del self.flows[fid]
        self.generation += 1
        w = getattr(tr, "weight", 1)
        self._total_w -= w
        key = (self._cap(tr), self._prio(tr))
        c = self.classes.get(key)
        if c is None or fid not in c.target:
            return                           # untracked flow
        tgt = c.target.pop(fid)
        tr.remaining_gb = max(tgt - c.served, 0.0)
        self._ntracked -= 1
        c.n -= 1
        c.w -= w
        if c.n == 0:
            self._active -= 1
            c.heap.clear()
            c.pred_t = math.inf
            c.pred_id += 1                   # stale any pending prediction
        if self._active:
            self._refresh_rates()

    def _refresh_rates(self):
        """Recompute every active class's per-member rate (rates change
        exactly when the flow set does). O(K log K) worst case; the
        single-class common case is the classic processor-sharing
        formula, no sort."""
        agg = self.aggregate_gbps
        if self._active == 1:
            for c in self.classes.values():
                if c.n:
                    # equal priorities cancel in the proportional share
                    c.rate = min(c.cap, agg / self._total_w)
                    return
            return
        active = sorted((c for c in self.classes.values() if c.n),
                        key=_class_order)
        remaining = agg
        claims = sum(c.w * c.prio for c in active)
        for c in active:
            r = min(c.cap, c.prio * remaining / claims)
            c.rate = r
            remaining -= r * c.w
            claims -= c.w * c.prio

    def take_drained(self, eps_gb: float = 1e-12) -> List[Any]:
        """Pop and return every flow whose remainder is within ``eps_gb``
        of drained (``remaining_gb`` is zeroed/materialized). O(k log n)
        in class mode, O(n) in the materialized fallback."""
        out: List[Any] = []
        if self._tracked():
            for c in list(self.classes.values()):
                heap, target = c.heap, c.target
                while heap:
                    tgt, fid = heap[0]
                    if target.get(fid) != tgt:
                        heapq.heappop(heap)      # stale (removed/re-added)
                        continue
                    if tgt - c.served > eps_gb:
                        break
                    tr = self.flows[fid]
                    out.append(tr)
                    self.remove_flow(tr)
        else:
            out = [tr for tr in self.flows.values()
                   if tr.remaining_gb <= eps_gb]
            for tr in out:
                self.remove_flow(tr)
        return out

    def rates(self) -> Dict[int, float]:
        """Max-min fair (water-filling) rate per flow id. Visiting classes
        narrowest-cap first, each takes ``min(cap, share left)`` — a
        capped class's unused equal share waterfalls to the wider classes
        behind it. Rates only change when the flow set does (every
        mutation bumps ``generation``), so the allocation is cached per
        (generation, flow count).

        A flow may carry ``weight`` member streams (a coalesced worker
        cohort): it counts as ``weight`` equal claimants on the link and
        its returned rate is the **per-member** rate — exactly the
        allocation ``weight`` identical singleton flows would get. A flow
        may also carry ``prio`` (default 1.0): each of its member streams
        claims ``prio`` shares, so under contention it holds a
        ``prio``-weighted fraction of the aggregate (still bounded by its
        own cap, and still spilling unused share to the others).

        The materialized fallback (directly-injected flows) groups the
        flow set by ``(cap, prio)`` and runs the *same* class-sequence
        arithmetic, so class-mode and materialized rates are bit-equal
        for identical flow sets."""
        key = (self.generation, len(self.flows))
        if key == self._rates_key:
            return self._rates
        if self._tracked():
            classes = self.classes
            default_cap = self.per_stream_gbps
            out = {}
            for fid, tr in self.flows.items():
                k = (getattr(tr, "cap_gbps", None) or default_cap,
                     self._prio(tr))
                out[fid] = classes[k].rate
            self._rates_key, self._rates = key, out
            return out
        # materialized fallback: group by (cap, prio), then the identical
        # per-class water-filling sequence
        groups: Dict[Tuple[float, float], list] = {}
        default_cap = self.per_stream_gbps
        total_w = 0
        for tr in self.flows.values():
            k = (getattr(tr, "cap_gbps", None) or default_cap,
                 self._prio(tr))
            w = getattr(tr, "weight", 1)
            total_w += w
            g = groups.get(k)
            if g is None:
                groups[k] = [w, [tr.fid]]
            else:
                g[0] += w
                g[1].append(tr.fid)
        out = {}
        if len(groups) == 1:
            (cap0, _prio0), (_w, fids) = next(iter(groups.items()))
            r = min(cap0, self.aggregate_gbps / total_w)
            out = dict.fromkeys(fids, r)
        else:
            order = sorted(groups.items(),
                           key=lambda kv: (kv[0][0] / kv[0][1],
                                           kv[0][0], kv[0][1]))
            remaining = self.aggregate_gbps
            claims = sum(w * k[1] for k, (w, _f) in order)
            for (cap, prio), (w, fids) in order:
                r = min(cap, prio * remaining / claims)
                for fid in fids:
                    out[fid] = r
                remaining -= r * w
                claims -= w * prio
        self._rates_key, self._rates = key, out
        return out

    def next_completion_dt(self) -> float:
        """Time until the first flow drains at the current per-flow rates.
        (``remaining_gb`` is per member, as is the rate.)"""
        if self._tracked():
            best = math.inf
            for c in self.classes.values():
                if not c.n:
                    continue
                heap, target = c.heap, c.target
                while heap and target.get(heap[0][1]) != heap[0][0]:
                    heapq.heappop(heap)          # lazy-deleted entries
                dt = max(heap[0][0] - c.served, 0.0) / c.rate
                if dt < best:
                    best = dt
            return best
        rates = self.rates()
        return min(tr.remaining_gb / rates[tr.fid]
                   for tr in self.flows.values())

    def progress(self, now: float):
        """Advance all flows to ``now`` at the rates that held since the
        last flow-set change (rates only change when the set does). In
        class mode only the per-class virtual-work integrals advance —
        O(K) regardless of flow count."""
        dt = now - self.last_t
        if dt > 0 and self.flows:
            if self._ntracked == len(self.flows):
                for c in self.classes.values():
                    if c.n:
                        c.served += c.rate * dt
            else:
                rates = self.rates()
                for tr in self.flows.values():
                    tr.remaining_gb = max(
                        tr.remaining_gb - rates[tr.fid] * dt, 0.0)
        self.last_t = now


class ObjectStore:
    """S3-like object store."""

    def __init__(self, *, latency_s: float = 0.030,
                 per_stream_gbps: float = 0.090,   # ~90 MB/s per connection
                 aggregate_gbps: float = 100.0):
        self.latency_s = latency_s
        self.per_stream_gbps = per_stream_gbps
        self.aggregate_gbps = aggregate_gbps
        self.blobs: Dict[str, Any] = {}
        self.stats = TransferStats()

    def put_time(self, nbytes: float, concurrent: int = 1) -> float:
        bw = min(self.per_stream_gbps, self.aggregate_gbps / max(concurrent, 1))
        return self.latency_s + nbytes / 1e9 / bw

    def get_time(self, nbytes: float, concurrent: int = 1) -> float:
        return self.put_time(nbytes, concurrent)

    def put(self, key: str, value: Any, nbytes: Optional[float] = None):
        self.blobs[key] = value
        self.stats.puts += 1
        self.stats.bytes_in += nbytes or 0

    def get(self, key: str, nbytes: Optional[float] = None) -> Any:
        self.stats.gets += 1
        self.stats.bytes_out += nbytes or 0
        return self.blobs[key]

    def request_cost(self) -> float:
        return (self.stats.puts * S3_PUT_PER_1K / 1000.0
                + self.stats.gets * S3_GET_PER_1K / 1000.0)

    def link(self) -> SharedLink:
        """A contended-bandwidth view of this store for the event engine."""
        return SharedLink("object", self.aggregate_gbps,
                          self.per_stream_gbps, self.latency_s)


class ParamStore:
    """Redis-like in-memory KV store on an ECS container."""

    def __init__(self, *, latency_s: float = 0.0008,
                 node_gbps: float = 5.0,          # 40 Gbit/s ECS container
                 vcpus: float = 2.0, memory_gb: float = 8.0):
        self.latency_s = latency_s
        self.node_gbps = node_gbps
        self.vcpus = vcpus
        self.memory_gb = memory_gb
        self.blobs: Dict[str, Any] = {}
        self.stats = TransferStats()
        self.alive_seconds = 0.0   # only billed while synchronization runs

    def xfer_time(self, nbytes: float, concurrent: int = 1,
                  per_fn_gbps: float = 10.0) -> float:
        bw = min(per_fn_gbps, self.node_gbps / max(concurrent, 1))
        return self.latency_s + nbytes / 1e9 / bw

    def put(self, key: str, value: Any, nbytes: Optional[float] = None):
        self.blobs[key] = value
        self.stats.puts += 1
        self.stats.bytes_in += nbytes or 0

    def get(self, key: str, nbytes: Optional[float] = None) -> Any:
        self.stats.gets += 1
        self.stats.bytes_out += nbytes or 0
        return self.blobs[key]

    def drop(self, key: str):
        """Free a payload once its synchronization phase is over (a Redis
        key expiring). Not a transfer, so the stats do not change; it keeps
        one step's gradients, not two, in device memory."""
        self.blobs.pop(key, None)

    def keep_alive(self, seconds: float):
        self.alive_seconds += seconds

    def link(self, per_fn_gbps: float = 10.0) -> SharedLink:
        """A contended-bandwidth view of this store for the event engine."""
        return SharedLink("param", self.node_gbps, per_fn_gbps,
                          self.latency_s)

    def container_cost(self) -> float:
        hours = self.alive_seconds / 3600.0
        return hours * (self.vcpus * ECS_VCPU_HOUR
                        + self.memory_gb * ECS_GB_HOUR)
