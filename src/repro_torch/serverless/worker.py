"""SMLT worker model (paper Section 4.2).

Two execution paths share the same interfaces:

 - **Analytic path** (paper-scale models, e.g. BERT-medium x 200 workers):
   per-iteration compute/communication times from a calibrated workload
   model (``Workload``, ``iteration_time``). The communication schedule is
   a ``core.comm.CommPlan`` priced in closed form with per-phase fan-in
   contention. The event engine and the scheduler build on it. A numpy
   copy of the JAX package's analytic half: the same arguments give the
   same times, bit for bit.
 - **Semantic path** (``LocalWorkerPool``): n logical workers each compute
   real PyTorch gradients on their minibatch slice and synchronize through
   the (simulated) stores with real tensor payloads. The plan's *strategy*
   selects matching numerics (shard aggregation, tree means, top-k +
   error-feedback sparse sync). Gradients, shards and aggregates stay on
   the device the gradients were computed on; the store holds references
   and counts each payload's f32 bytes, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core import tree as T
from repro_torch.core.comm import (CommLike, CommPlan, build_plan,
                                   overlap_iteration_time, plan_times)
from repro_torch.core.rng import base_stream
from repro_torch.serverless.backends import BackendLike, resolve_backend
from repro_torch.serverless.platform import FleetSpec, fn_gflops, fn_net_gbps
from repro_torch.serverless.stores import ObjectStore, ParamStore

# ---------------------------------------------------------------------------
# analytic workload model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Workload:
    """Calibrated description of one training task (paper Section 5.1)."""
    name: str
    param_count: int
    flops_per_sample: float          # fwd+bwd FLOPs per training sample
    sample_bytes: float              # bytes of one training sample
    dataset_samples: int
    extra_upload_bytes: float = 0.0  # e.g. Atari RL simulation data

    @property
    def grad_bytes(self) -> float:
        return 4.0 * self.param_count  # f32 gradients


# Paper benchmark models (Section 5.1)
WORKLOADS = {
    "resnet18": Workload("resnet18", 11_000_000, 5.4e9, 150e3, 1_281_167),
    "resnet50": Workload("resnet50", 23_000_000, 12.0e9, 150e3, 1_281_167),
    "bert-small": Workload("bert-small", 66_000_000, 5.1e10, 2_048, 1_000_000),
    "bert-medium": Workload("bert-medium", 110_000_000, 8.4e10, 2_048, 1_000_000),
    "atari-rl": Workload("atari-rl", 50_000_000, 4.0e10, 33_600, 50_000_000,
                         extra_upload_bytes=4.0 * 50_000_000),
}


def compute_time(w: Workload, local_batch: float, memory_mb: float,
                 gflops: Optional[float] = None) -> float:
    """Per-iteration compute seconds; ``gflops`` overrides the
    memory-derived function rate (VM/GPU backends have flat rates)."""
    rate = gflops if gflops is not None else fn_gflops(memory_mb)
    return w.flops_per_sample * local_batch / (rate * 1e9)


def fleet_local_batches(fleet: FleetSpec, global_batch: int) -> List[float]:
    """Load-aware shard placement: the global batch splits in proportion
    to each worker's compute rate, so every worker's compute time is the
    same ``flops * global_batch / sum(rates)`` — the mixed fleet stops
    paying the bsp barrier at its slowest worker's *compute* (network
    caps remain per-worker). Exactly the equal split for homogeneous
    fleets."""
    rates = [fn_gflops(m) for m in fleet.memories]
    total = sum(rates)
    return [global_batch * r / total for r in rates]


def comm_breakdown(scheme: CommLike, grad_bytes: float, n_workers: int,
                   memory_mb: float, param_store: ParamStore,
                   object_store: ObjectStore,
                   n_shards: Optional[int] = None,
                   extra_upload_bytes: float = 0.0,
                   topk_ratio: float = 0.05,
                   fn_net_override_gbps: Optional[float] = None
                   ) -> Dict[str, float]:
    """Static per-phase times of the communication plan. Each phase runs
    with its own ``fan_in`` workers contending (the event engine relaxes
    this to *actual* overlap). ``fn_net_override_gbps`` replaces the
    memory-derived per-function bandwidth — the mixed-fleet approximation
    passes the *narrowest* worker's pipe (a barriered exchange is bound
    by it)."""
    fn_net = (fn_net_override_gbps if fn_net_override_gbps is not None
              else fn_net_gbps(memory_mb))
    fn_bw = fn_net * 8  # not a bottleneck vs store; keep wide
    plan = build_plan(scheme, grad_bytes, n_workers, n_shards=n_shards,
                      extra_upload_bytes=extra_upload_bytes,
                      topk_ratio=topk_ratio)
    times, _busy = plan_times(plan, param_store, object_store, fn_bw)
    return times


def iteration_time(w: Workload, scheme: CommLike, n_workers: int,
                   memory_mb: float, global_batch: int,
                   param_store: ParamStore, object_store: ObjectStore, *,
                   fleet: Optional[FleetSpec] = None,
                   backend: BackendLike = None) -> Dict[str, float]:
    """Closed-form per-iteration time. With a ``fleet``, the mixed-memory
    approximation the Bayesian optimizer probes with: load-aware batch
    placement makes compute ``flops * batch / sum(worker rates)`` (exact,
    since every worker finishes its proportional slice together), while
    synchronization keeps the min-bandwidth bound (narrowest worker's
    pipe). Besides ``compute``/``comm``/``total`` and the per-phase
    entries, the breakdown carries ``store_busy`` — the seconds the
    param store is held by transfers (the keep-alive billing basis,
    which excludes any decompress CPU in ``comm`` and every
    object-store phase). A pipelined plan (``pipeline_depth > 1``)
    prices the iteration as ``max(compute, hidden comm) + exposed comm
    + bubble`` — the overlappable uploads hide under segmented compute
    — and reports the split under ``comm_hidden`` / ``comm_exposed`` /
    ``bubble`` (``comm`` stays the total communication *work*, hidden
    or not; ``store_busy`` is likewise unchanged by overlap, since a
    hidden transfer still holds the store)."""
    n_workers = len(fleet) if fleet is not None else n_workers
    spec = resolve_backend(backend)
    if spec is not None:
        # VM-kind backend: a flat per-worker compute rate and NIC make
        # the fleet homogeneous regardless of the memory tiers
        local_batch = max(global_batch // n_workers, 1)
        comp = compute_time(w, local_batch, memory_mb,
                            gflops=spec.gflops_for(memory_mb))
        net_override = spec.net_gbps_for(memory_mb)
    elif fleet is None or fleet.is_homogeneous:
        mem = fleet.memories[0] if fleet is not None else memory_mb
        local_batch = max(global_batch // n_workers, 1)
        comp = compute_time(w, local_batch, mem)
        net_override = None if fleet is None else fleet.min_net_gbps()
    else:
        comp = (w.flops_per_sample * global_batch
                / (fleet.gflops_total() * 1e9))
        net_override = fleet.min_net_gbps()
    fn_net = (net_override if net_override is not None
              else fn_net_gbps(memory_mb))
    plan = build_plan(scheme, w.grad_bytes, n_workers,
                      extra_upload_bytes=w.extra_upload_bytes)
    comm, store_busy = plan_times(plan, param_store, object_store, fn_net * 8)
    hidden_names = {ph.name for ph in plan.overlappable_phases}
    hidden = sum(t for name, t in comm.items() if name in hidden_names)
    exposed = sum(comm.values()) - hidden
    ov = overlap_iteration_time(comp, hidden, exposed, plan.pipeline_depth)
    return {"compute": comp, "comm": sum(comm.values()),
            "total": ov["total"], "store_busy": store_busy,
            "comm_hidden": ov["comm_hidden"],
            "comm_exposed": ov["comm_exposed"], "bubble": ov["bubble"],
            **comm}


# ---------------------------------------------------------------------------
# gradient sharding math
# ---------------------------------------------------------------------------


def flatten_grads(grads) -> torch.Tensor:
    """All leaves, in ``jax.tree.leaves`` order, as one f32 vector on the
    leaves' device (written slice by slice: no second full-size copy)."""
    ls = T.leaves(grads)
    out = torch.empty(sum(x.numel() for x in ls), dtype=torch.float32,
                      device=ls[0].device)
    off = 0
    for x in ls:
        out[off:off + x.numel()].copy_(x.reshape(-1))
        off += x.numel()
    return out


def unflatten_grads(flat: torch.Tensor, grads_like):
    out, off = [], 0
    for leaf in T.leaves(grads_like):
        n = leaf.numel()
        out.append(flat[off:off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return T.unflatten(grads_like, out)


def make_shards(flat: torch.Tensor, m: int) -> List[torch.Tensor]:
    """Split a flat gradient into m equal shards (shard generator, Fig 5);
    the rows are views of ``flat`` unless it needs zero padding."""
    pad = (-flat.numel()) % m
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return list(flat.reshape(m, -1))


def join_shards(shards: List[torch.Tensor], size: int) -> torch.Tensor:
    return torch.cat(shards)[:size]


def parse_sync_mode(sync_mode: str, staleness: int = 0):
    """Parse ``"bsp" | "ssp" | "ssp(k)" | "async"`` into (mode, bound).

    bsp is ssp with bound 0; async is ssp with an unbounded window."""
    m = sync_mode.strip().lower()
    if m.startswith("ssp(") and m.endswith(")"):
        return "ssp", int(m[4:-1])
    if m == "bsp":
        return "bsp", 0
    if m == "ssp":
        return "ssp", staleness
    if m == "async":
        return "async", None
    raise ValueError(f"sync_mode {sync_mode!r}")


class LocalWorkerPool:
    """Semantic SMLT: n logical workers with real PyTorch grads,
    synchronizing via the (simulated) param store under a ``CommPlan``.

    ``plan`` (a ``CommPlan``, ``CommSpec``, or legacy scheme string)
    selects the synchronization numerics:
      - ``scatter_reduce`` (default; legacy scheme "hier"): workers shard
        their gradients, worker j aggregates shard j from everyone and
        re-uploads it, exactly as Figure 5 prescribes.
      - ``ps``: every worker uploads its full gradient; the mean is taken
        over all n full gradients.
      - ``hier``: partial sums reduce up a ``branching``-ary tree of
        group aggregators; the root mean is redistributed.
      - a compressed plan (``ratio < 1``): top-k sparse uploads with
        per-worker error feedback (``core.compression``).
      - a pipelined plan (``pipeline_depth > 1``): micro-batched gradient
        accumulation; the weighted mean equals the full-slice gradient.

    ``use_kernel=True`` runs the shard aggregation (step 3 of Fig. 5)
    through ``kernels.ops.aggregate_shards``: the hand-written CUDA kernel
    on a CUDA tensor, its plain version on a CPU tensor.

    ``sync_mode``: "bsp" (current params), "ssp(k)" (worker w refreshes
    every k+1 steps, staggered by id) or "async" (seeded geometric gaps).

    ``grad_fn(params, batch)`` returns a gradient tree like ``params``;
    ``batch`` is a dict of tensors with a leading dim divisible by n.
    """

    def __init__(self, grad_fn: Callable, n_workers: int,
                 param_store: ParamStore, *, use_kernel: bool = False,
                 plan: Optional[CommLike] = None,
                 sync_mode: str = "bsp", staleness: int = 0, seed: int = 0,
                 async_refresh_p: float = 0.5):
        self.grad_fn = grad_fn
        self.n = n_workers
        self.store = param_store
        self.use_kernel = use_kernel
        if isinstance(plan, CommPlan):
            if plan.n_workers != n_workers:
                raise ValueError(f"plan built for n={plan.n_workers}, "
                                 f"pool has n={n_workers}")
            self.plan = plan
        else:
            self.plan = build_plan(plan if plan is not None else "hier",
                                   1.0, n_workers)
        self.mode, self.staleness = parse_sync_mode(sync_mode, staleness)
        self.async_refresh_p = async_refresh_p
        self._rng = base_stream(seed)
        self._iter = 0
        self._snaps: List = [None] * n_workers    # stale param snapshots
        self._vers = [0] * n_workers
        self._ef: Dict = {}                        # compressed path only

    def _worker_params(self, w: int, params):
        """The (possibly stale) params worker ``w`` computes gradients at."""
        if self.mode == "bsp":
            return params
        if self._snaps[w] is None:
            refresh = True
        elif self.mode == "ssp":
            k = self.staleness
            refresh = ((self._iter + w) % (k + 1) == 0
                       or self._iter - self._vers[w] > k)
        else:                                      # async: unbounded gaps
            refresh = self._rng.random_sample() < self.async_refresh_p
        if refresh:
            self._snaps[w] = params
            self._vers[w] = self._iter
        return self._snaps[w]

    def _slice_grad(self, params, sl):
        """One worker's gradient on its batch slice; a pipelined plan takes
        it as segment-size-weighted micro-batch accumulation."""
        d = self.plan.pipeline_depth
        rows = T.leaves(sl)[0].shape[0]
        if d <= 1 or rows < 2:
            return self.grad_fn(params, sl)
        d = min(d, rows)
        bounds = [round(i * rows / d) for i in range(d + 1)]
        acc, total = None, 0
        for a, b in zip(bounds, bounds[1:]):
            if b <= a:
                continue
            micro = T.tree_map(lambda x: x[a:b], sl)
            g = self.grad_fn(params, micro)
            wgt = float(b - a)
            if acc is None:
                acc = T.tree_map(lambda x: x.float() * wgt, g)
            else:
                acc = T.tree_map(lambda s, x: s + x.float() * wgt, acc, g)
            total += wgt
        return T.tree_map(lambda s: s / total, acc)

    def _worker_grads(self, params, global_batch):
        """Each worker's flat gradient on its batch slice (stale-aware)."""
        n = self.n
        flats, g_like = [], None
        for w in range(n):
            sl = T.tree_map(
                lambda x: x[w * (x.shape[0] // n):(w + 1) * (x.shape[0] // n)],
                global_batch)
            g = self._slice_grad(self._worker_params(w, params), sl)
            flats.append(flatten_grads(g))
            g_like = g
        return flats, g_like

    def step(self, params, global_batch) -> Dict:
        """Returns the aggregated (mean) gradient tree."""
        if self.plan.ratio < 1.0:
            mean_flat, g_like = self._step_compressed(params, global_batch)
        elif self.plan.strategy == "ps":
            mean_flat, g_like = self._step_ps(params, global_batch)
        elif self.plan.strategy == "hier":
            mean_flat, g_like = self._step_hier(params, global_batch)
        else:
            mean_flat, g_like = self._step_scatter_reduce(params,
                                                          global_batch)
        self._iter += 1
        return unflatten_grads(mean_flat, g_like)

    # -- strategy numerics ---------------------------------------------------
    def _step_scatter_reduce(self, params, global_batch):
        n = self.n
        flats, g_like = self._worker_grads(params, global_batch)
        flat_size = flats[0].numel()
        # (1) each worker shards its gradient and uploads the shards
        for w, flat in enumerate(flats):
            for j, s in enumerate(make_shards(flat, n)):
                self.store.put(f"shard/{w}/{j}", s, nbytes=s.nbytes)
        del flats
        # (2) worker j aggregates shard j from all workers (mean), re-uploads
        for j in range(n):
            stacked = torch.stack([self.store.get(f"shard/{w}/{j}")
                                   for w in range(n)])
            for w in range(n):
                self.store.drop(f"shard/{w}/{j}")
            if self.use_kernel:
                from repro_torch.kernels import ops as kops
                agg = kops.aggregate_shards(stacked)
            else:
                agg = stacked.mean(dim=0)
            del stacked
            self.store.put(f"aggr/{j}", agg, nbytes=agg.nbytes)
        # (3) every worker downloads all aggregated shards -> updated model;
        # they are identical, so reconstruct once.
        agg = [self.store.get(f"aggr/{j}") for j in range(n)]
        for j in range(n):
            self.store.drop(f"aggr/{j}")
        return join_shards(agg, flat_size), g_like

    def _step_ps(self, params, global_batch):
        n = self.n
        flats, g_like = self._worker_grads(params, global_batch)
        for w, flat in enumerate(flats):
            self.store.put(f"grad/{w}", flat, nbytes=flat.nbytes)
        acc = torch.zeros_like(flats[0])
        for w in range(n):
            acc += self.store.get(f"grad/{w}", nbytes=flats[w].nbytes)
            self.store.drop(f"grad/{w}")
        return acc / n, g_like

    def _step_hier(self, params, global_batch):
        """Tree aggregation: partial sums reduce level by level through
        the store; the root's sum / n is the exact global mean."""
        n, b = self.n, max(self.plan.branching or 4, 2)
        flats, g_like = self._worker_grads(params, global_batch)
        nbytes = flats[0].nbytes
        partials = list(flats)                   # level-0 partial sums
        del flats
        lvl = 0
        while len(partials) > 1:
            lvl += 1
            for i, p in enumerate(partials):
                self.store.put(f"hier/{lvl}/{i}", p, nbytes=nbytes)
            nxt = []
            for g0 in range(0, len(partials), b):
                members = range(g0, min(g0 + b, len(partials)))
                nxt.append(sum(self.store.get(f"hier/{lvl}/{i}",
                                              nbytes=nbytes)
                               for i in members))
            for i in range(len(partials)):
                self.store.drop(f"hier/{lvl}/{i}")
            partials = nxt
        root = partials[0]
        self.store.put("hier/root", root, nbytes=nbytes)
        out = self.store.get("hier/root", nbytes=nbytes) / n
        self.store.drop("hier/root")
        return out, g_like

    def _step_compressed(self, params, global_batch):
        """Top-k + error feedback: each worker uploads only its k largest
        (corrected) entries; the aggregator sums sparse contributions."""
        from repro_torch.core.compression import (ErrorFeedback,
                                                  compressed_bytes)
        n, ratio = self.n, self.plan.ratio
        flats, g_like = self._worker_grads(params, global_batch)
        size = flats[0].numel()
        for w, flat in enumerate(flats):
            if w not in self._ef:
                self._ef[w] = ErrorFeedback.init(size, flat.device)
            idx, vals = self._ef[w].compress(flat, ratio)
            self.store.put(f"sparse/{w}", (idx, vals),
                           nbytes=compressed_bytes(size, ratio))
        acc = torch.zeros(size, dtype=torch.float32, device=flats[0].device)
        for w in range(n):
            idx, vals = self.store.get(
                f"sparse/{w}", nbytes=compressed_bytes(size, ratio))
            self.store.drop(f"sparse/{w}")
            acc[idx.long()] += vals
        return acc / n, g_like
