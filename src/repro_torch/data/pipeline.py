"""Data pipeline: sharded synthetic token stream + the paper's data-iterator
semantics (per-worker shards from the object store, resumable position
tracking for function restarts, online-learning arrival stream).

Real corpora are out of scope offline; the pipeline generates deterministic
pseudo-token streams keyed by (seed, epoch, shard) so restarts and elastic
rescaling are exactly reproducible — which is what the paper's data iterator
bookkeeping guarantees (Section 4.2).

A numpy copy of the JAX package's ``data/pipeline.py``: the same seed gives
the same tokens, bit for bit. Batches are numpy; ``core.tree.from_numpy``
moves them to a device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.rng import base_stream


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    dataset_tokens: int = 1 << 22
    seed: int = 0


class TokenDataset:
    """Deterministic synthetic LM dataset with markov-ish structure (so loss
    actually decreases during the example training runs)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = base_stream(cfg.seed)
        # low-entropy transition structure: next token ~ f(prev token)
        self._shift = rng.randint(1, 17)
        self._noise = 0.1

    def sample(self, epoch: int, index: int, n: int, seq: int) -> np.ndarray:
        rng = base_stream(
            (self.cfg.seed * 1_000_003 + epoch * 7919 + index) % (2 ** 31))
        start = rng.randint(0, self.cfg.vocab_size, size=(n, 1))
        steps = rng.randint(0, self.cfg.vocab_size, size=(n, seq))
        noisy = rng.random_sample((n, seq)) < self._noise
        out = np.zeros((n, seq), np.int32)
        cur = start[:, 0]
        for t in range(seq):
            cur = np.where(noisy[:, t], steps[:, t],
                           (cur + self._shift) % self.cfg.vocab_size)
            out[:, t] = cur
        return out


@dataclasses.dataclass
class IteratorState:
    """Resumable position (paper: 'tracks which training data points have
    been processed ... in case the worker needs to resume after a restart')."""
    epoch: int = 0
    index: int = 0  # samples consumed within the epoch


class ShardedLoader:
    """Yields global batches; each logical worker's slice is contiguous, so
    the same stream can be re-sliced when the fleet is rescaled."""

    def __init__(self, ds: TokenDataset, state: Optional[IteratorState] = None):
        self.ds = ds
        self.state = state or IteratorState()

    def next_batch(self, global_batch: int) -> Dict[str, np.ndarray]:
        s = self.state
        toks = self.ds.sample(s.epoch, s.index, global_batch, self.ds.cfg.seq_len)
        s.index += global_batch
        epoch_samples = self.ds.cfg.dataset_tokens // self.ds.cfg.seq_len
        if s.index >= epoch_samples:
            s.epoch += 1
            s.index = 0
        return {"tokens": toks, "labels": toks.copy()}


class OnlineStream:
    """Online-learning arrival process: samples/sec with diurnal variation
    (drives the paper's 24-hour online-training experiment, Fig. 11b)."""

    def __init__(self, base_rate: float, seed: int = 0,
                 period_s: float = 86_400.0, amplitude: float = 0.5):
        self.base_rate = base_rate
        self.period = period_s
        self.amp = amplitude
        self.rng = base_stream(seed)

    def arrivals(self, t0: float, dt: float) -> int:
        mid = t0 + dt / 2
        rate = self.base_rate * (1 + self.amp * np.sin(2 * np.pi * mid / self.period))
        return int(self.rng.poisson(max(rate, 0.0) * dt))
