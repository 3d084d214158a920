"""Memoizing probe cache for the analytic cost model.

``epoch_estimate``/``profile_cost``/``iteration_time`` are pure
functions of their inputs: the workload's calibration numbers, the comm
scheme, the deployment config, the batch, and the stores' *parameters*
(latency/bandwidth/pricing — never their mutable blob/stat state). The
Bayesian optimizer re-evaluates the same closed forms hundreds of times
per training run — every re-optimization sweeps overlapping candidate
sets, Hyperband rungs re-probe surviving configs, and the workflow
allocator forecasts each task repeatedly under one deadline.

``ProbeCache`` memoizes those calls on the hashable
``(workload, scheme, config, batch, store-params, fleet, kwargs)``
tuple. Results are returned as defensive copies (``EpochEstimate`` and
the iteration-breakdown dict are mutable), so a caller that annotates
its estimate cannot poison the cache.

A process-wide ``DEFAULT_CACHE`` is shared by every ``TaskScheduler``
(and the workflow orchestrator's whole fleet of them) — safe because
keys capture *all* inputs, and profitable because concurrent tasks
probe overlapping config spaces. Pass ``probe_cache=None`` to a
scheduler to opt out, or a private instance to isolate hit/miss
accounting (as the unit tests do).

A copy of the JAX package's ``core/probe_cache.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import cost_model as _cm
from repro_torch.serverless.backends import resolve_backend
from repro_torch.serverless.platform import FleetSpec
from repro_torch.serverless.stores import ObjectStore, ParamStore
from repro_torch.serverless.worker import Workload


def _store_key(store) -> Tuple:
    """A store's *parameters* — the only state the cost model reads."""
    if isinstance(store, ParamStore):
        return ("param", store.latency_s, store.node_gbps, store.vcpus,
                store.memory_gb)
    if isinstance(store, ObjectStore):
        return ("object", store.latency_s, store.per_stream_gbps,
                store.aggregate_gbps)
    # unknown store type: fall back to identity (correct, never shared)
    return ("id", id(store))


def probe_key(w: Workload, scheme, config, global_batch: int,
              param_store, object_store,
              fleet: Optional[FleetSpec] = None, **kwargs) -> Tuple:
    """The full-input hash key one cost-model probe is memoized under.
    ``scheme`` (str/CommSpec/CommPlan), ``config`` (frozen Config), and
    ``fleet.workers`` (frozen WorkerSpecs) are hashable as-is.

    Kwargs are normalized so equivalent calls share one entry and
    distinct ones never collide: ``None``-valued kwargs (the defaults)
    are dropped, and ``backend`` is canonicalized through
    ``resolve_backend`` — ``None``/``""``/``"serverless"`` all key as
    absent, while a name and its resolved ``BackendSpec`` (frozen, its
    ``PriceTrace`` tuple-backed — spot price and bid included) key
    identically, so cached estimates never leak across backends."""
    if "backend" in kwargs:
        spec = resolve_backend(kwargs["backend"])
        if spec is None:
            del kwargs["backend"]
        else:
            kwargs["backend"] = spec
    return (dataclasses.astuple(w), scheme, config, global_batch,
            _store_key(param_store), _store_key(object_store),
            None if fleet is None else fleet.workers,
            tuple(sorted((k, v) for k, v in kwargs.items()
                         if v is not None)))


class ProbeCache:
    """Bounded memo table over the analytic cost-model entry points."""

    def __init__(self, maxsize: int = 8192):
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._d: Dict[Tuple, Any] = {}

    def __len__(self) -> int:
        return len(self._d)

    def clear(self):
        self._d.clear()
        self.hits = 0
        self.misses = 0

    def _put(self, key: Tuple, value):
        if len(self._d) >= self.maxsize:
            # drop the oldest half (dict preserves insertion order) —
            # cheap, and BO probe streams are strongly front-loaded
            for k in list(self._d)[:self.maxsize // 2]:
                del self._d[k]
        self._d[key] = value

    # -- cached entry points -------------------------------------------------
    def epoch_estimate(self, w: Workload, scheme, config, global_batch: int,
                       param_store, object_store, **kwargs):
        key = ("epoch", probe_key(w, scheme, config, global_batch,
                                  param_store, object_store, **kwargs))
        est = self._d.get(key)
        if est is None:
            self.misses += 1
            est = _cm.epoch_estimate(w, scheme, config, global_batch,
                                     param_store, object_store, **kwargs)
            self._put(key, est)
        else:
            self.hits += 1
        # defensive copy: EpochEstimate (and its breakdown dict) is mutable
        return dataclasses.replace(est, it_breakdown=dict(est.it_breakdown))

    def profile_cost(self, w: Workload, scheme, config, global_batch: int,
                     param_store, object_store, profile_iters: int = 3,
                     **kwargs):
        key = ("profile", probe_key(w, scheme, config, global_batch,
                                    param_store, object_store,
                                    profile_iters=profile_iters, **kwargs))
        hit = self._d.get(key)
        if hit is None:
            self.misses += 1
            hit = _cm.profile_cost(w, scheme, config, global_batch,
                                   param_store, object_store, profile_iters,
                                   **kwargs)
            self._put(key, hit)
        else:
            self.hits += 1
        wall, usd, it = hit
        return wall, usd, dict(it)


# One shared table per process: every scheduler benefits from every
# other's probes (keys capture all inputs, so sharing is always sound).
DEFAULT_CACHE = ProbeCache()
