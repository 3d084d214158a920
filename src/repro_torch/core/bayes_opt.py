"""Bayesian optimizer for deployment configuration search (paper Section 3.2).

Gaussian-Process regression posterior + Expected Improvement acquisition,
exactly as the paper specifies:

    EI(C_i) = (y_best - mu(C_i)) * Phi(gamma) + sigma(C_i) * phi(gamma)

(the paper's beta/theta are the standard normal CDF/PDF; y_max is "the
current lowest value from all explored tuples", i.e. minimization). The
search space is 2-D: number of workers (scale-out) x per-worker memory in MB
(scale-up, 128MB..10GB at 1MB granularity per AWS Lambda quotas).

Constrained goals (deadline / budget) use feasibility-weighted EI: a second
GP models the constraint metric and EI is multiplied by P(feasible).

A copy of the JAX package's ``core/bayes_opt.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np


def _norm_cdf(x):
    return 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


def _norm_pdf(x):
    return np.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


class GP:
    """RBF-kernel GP regression with input scaling + output standardization."""

    def __init__(self, length_scale: float = 0.2, noise: float = 1e-4,
                 signal: float = 1.0):
        self.ls = length_scale
        self.noise = noise
        self.signal = signal
        self._fit = None

    def _k(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return self.signal * np.exp(-0.5 * d2 / self.ls ** 2)

    def fit(self, X: np.ndarray, y: np.ndarray):
        X = np.atleast_2d(np.asarray(X, float))
        y = np.asarray(y, float)
        self.ymu, self.ystd = y.mean(), max(y.std(), 1e-12)
        yn = (y - self.ymu) / self.ystd
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(self.L.T, np.linalg.solve(self.L, yn))
        self.X = X
        self._fit = True
        return self

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Xs = np.atleast_2d(np.asarray(Xs, float))
        Ks = self._k(self.X, Xs)
        mu = Ks.T @ self.alpha
        v = np.linalg.solve(self.L, Ks)
        var = np.maximum(self._k(Xs, Xs).diagonal() - (v * v).sum(0), 1e-12)
        return mu * self.ystd + self.ymu, np.sqrt(var) * self.ystd


def expected_improvement(mu, sigma, y_best):
    """EI for minimization (paper's formula with y_best = lowest observed)."""
    gamma = (y_best - mu) / np.maximum(sigma, 1e-12)
    return (y_best - mu) * _norm_cdf(gamma) + sigma * _norm_pdf(gamma)


@dataclasses.dataclass(frozen=True)
class Config:
    """One deployment configuration
    C_i = <workers, memory[, fleet mix][, comm plan]>.

    ``small_frac`` is the searchable fleet-composition dimension: the
    fraction of the fleet deployed as a cheaper half-memory "small" tier
    (see ``repro_torch.serverless.platform.fleet_from_config``). 0.0 keeps the
    paper's homogeneous 2-D space.

    ``comm``/``compress_ratio``/``branching``/``pipeline_depth`` are the
    searchable communication-plan dimensions
    (``repro_torch.core.comm.CommSpec``): the aggregation strategy ("" keeps
    the scheduler's default scheme), the top-k wire ratio (1.0 = dense),
    the hier tree fan-in (0 = n/a), and the compute∥comm overlap depth
    (micro-batch segments; 1 = sequential).

    ``backend`` is the searchable execution target
    (``repro_torch.serverless.backends.BACKENDS``): "" (or "serverless") keeps
    the native serverless path; "vm"/"gpu_vm" swap in provisioning
    delays, flat compute/NIC rates, and per-second billing."""
    workers: int
    memory_mb: int
    small_frac: float = 0.0
    comm: str = ""                     # "" | "ps" | "scatter_reduce" | "hier"
    compress_ratio: float = 1.0
    branching: int = 0
    pipeline_depth: int = 1
    backend: str = ""                  # "" | "serverless" | "vm" | "gpu_vm"

    _COMM_IDX = ("", "ps", "scatter_reduce", "hier")
    _BACKEND_IDX = ("serverless", "vm", "gpu_vm")

    def as_unit(self, space: "ConfigSpace") -> np.ndarray:
        return np.array([
            (self.workers - space.min_workers)
            / max(space.max_workers - space.min_workers, 1),
            (self.memory_mb - space.min_memory)
            / max(space.max_memory - space.min_memory, 1),
            self.small_frac,
            self._COMM_IDX.index(self.comm)
            / (len(self._COMM_IDX) - 1),
            # ratio on a log scale: 1.0 -> 0, 0.01 -> 1
            min(math.log10(1.0 / max(self.compress_ratio, 1e-4)) / 2.0, 1.0),
            0.0 if self.branching <= 0 else min(
                math.log2(self.branching) / 4.0, 1.0),
            # overlap depth on a log scale: 1 -> 0, 8 -> 1
            0.0 if self.pipeline_depth <= 1 else min(
                math.log2(self.pipeline_depth) / 3.0, 1.0),
            # backend as an ordinal ("" == serverless == 0)
            0.0 if self.backend == "" else (
                self._BACKEND_IDX.index(self.backend)
                / (len(self._BACKEND_IDX) - 1)),
        ])


@dataclasses.dataclass
class ConfigSpace:
    min_workers: int = 1
    max_workers: int = 200
    min_memory: int = 128
    max_memory: int = 10_240
    memory_step: int = 1           # 1 MB granularity (paper / Lambda quotas)
    # fleet composition: when True, candidates also draw a small-tier
    # fraction, letting the optimizer trade a cheaper mixed fleet against
    # the bsp barrier cost of its slowest workers
    search_fleet: bool = False
    small_frac_choices: Tuple[float, ...] = (0.0, 0.25, 0.5)
    # communication plan: when True, candidates also draw an aggregation
    # strategy, a top-k compression ratio, a hier-tree branching, and a
    # compute∥comm overlap depth — the optimizer trades wire bytes
    # against the convergence cost of sparsification
    # (constraints.compression_inflation) and hides pre-barrier uploads
    # under segmented compute (CommPlan.pipeline)
    search_comm: bool = False
    comm_choices: Tuple[str, ...] = ("scatter_reduce", "hier", "ps")
    ratio_choices: Tuple[float, ...] = (1.0, 0.1, 0.05, 0.01)
    branching_choices: Tuple[int, ...] = (2, 4, 8)
    depth_choices: Tuple[int, ...] = (1, 2, 4)
    # execution target: when True, candidates also draw a backend, so the
    # optimizer can arbitrage serverless elasticity against flat-rate
    # VM/GPU compute (the scheduler migrates on a backend change)
    search_backend: bool = False
    backend_choices: Tuple[str, ...] = ("serverless", "vm", "gpu_vm")

    def sample(self, rng: np.random.RandomState, n: int) -> List[Config]:
        ws = rng.randint(self.min_workers, self.max_workers + 1, size=n)
        ms = rng.randint(0, (self.max_memory - self.min_memory)
                         // self.memory_step + 1, size=n)
        if self.search_fleet:
            fr = [self.small_frac_choices[i] for i in
                  rng.randint(len(self.small_frac_choices), size=n)]
        else:
            fr = [0.0] * n
        if self.search_comm:
            cm = [self.comm_choices[i] for i in
                  rng.randint(len(self.comm_choices), size=n)]
            ra = [self.ratio_choices[i] for i in
                  rng.randint(len(self.ratio_choices), size=n)]
            br = [self.branching_choices[i] for i in
                  rng.randint(len(self.branching_choices), size=n)]
            dp = [self.depth_choices[i] for i in
                  rng.randint(len(self.depth_choices), size=n)]
        else:
            cm, ra, br, dp = [""] * n, [1.0] * n, [0] * n, [1] * n
        # drawn *after* every earlier dimension so existing search
        # configurations consume the rng stream identically (bit-identity)
        if self.search_backend:
            be = [self.backend_choices[i] for i in
                  rng.randint(len(self.backend_choices), size=n)]
        else:
            be = [""] * n
        return [Config(int(w), int(self.min_memory + m * self.memory_step),
                       float(f), c, float(r), int(b) if c == "hier" else 0,
                       int(d), e)
                for w, m, f, c, r, b, d, e in zip(ws, ms, fr, cm, ra, br,
                                                  dp, be)]


@dataclasses.dataclass
class Observation:
    config: Config
    objective: float
    constraint: Optional[float] = None  # metric compared against a threshold


class BayesianOptimizer:
    """Iterative GP+EI search; optionally constraint-aware."""

    def __init__(self, space: ConfigSpace, *,
                 constraint_limit: Optional[float] = None,
                 n_init: int = 3, n_candidates: int = 512, seed: int = 0,
                 ei_tolerance: float = 1e-3, max_iters: int = 20):
        self.space = space
        self.constraint_limit = constraint_limit
        self.n_init = n_init
        self.n_candidates = n_candidates
        from repro_torch.core.rng import base_stream
        self.rng = base_stream(seed)
        self.ei_tolerance = ei_tolerance
        self.max_iters = max_iters
        self.obs: List[Observation] = []
        # unit-cube embedding per observation, computed once at observe
        # time: suggest() refits the GP on every call, and re-embedding
        # the whole history each time was the dominant non-GP cost
        self._X: List[np.ndarray] = []

    # -- bookkeeping ---------------------------------------------------------
    def observe(self, config: Config, objective: float,
                constraint: Optional[float] = None):
        self.obs.append(Observation(config, float(objective),
                                    None if constraint is None
                                    else float(constraint)))
        self._X.append(config.as_unit(self.space))

    def _feasible(self, o: Observation) -> bool:
        return (self.constraint_limit is None or o.constraint is None
                or o.constraint <= self.constraint_limit)

    def best(self) -> Optional[Observation]:
        feas = [o for o in self.obs if self._feasible(o)]
        pool = feas or self.obs
        return min(pool, key=lambda o: o.objective) if pool else None

    # -- acquisition ---------------------------------------------------------
    def suggest(self) -> Config:
        if len(self.obs) < self.n_init:
            return self.space.sample(self.rng, 1)[0]
        X = np.stack(self._X)
        y = np.array([o.objective for o in self.obs])
        gp = GP().fit(X, y)
        cands = self.space.sample(self.rng, self.n_candidates)
        Xc = np.stack([c.as_unit(self.space) for c in cands])
        best = self.best()
        mu, sig = gp.predict(Xc)
        acq = expected_improvement(mu, sig, best.objective)
        if (self.constraint_limit is not None
                and any(o.constraint is not None for o in self.obs)):
            yc = np.array([o.constraint for o in self.obs])
            gpc = GP().fit(X, yc)
            mc, sc = gpc.predict(Xc)
            p_feas = _norm_cdf((self.constraint_limit - mc)
                               / np.maximum(sc, 1e-12))
            acq = acq * p_feas
        return cands[int(np.argmax(acq))]

    def done(self) -> bool:
        if len(self.obs) >= self.max_iters:
            return True
        if len(self.obs) <= self.n_init + 1:
            return False
        recent = [o.objective for o in self.obs[-3:] if self._feasible(o)]
        best = self.best()
        if best is None or len(recent) < 3:
            return False
        span = max(recent) - min(recent)
        return span < self.ei_tolerance * max(abs(best.objective), 1e-9)
