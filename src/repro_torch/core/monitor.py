"""Training-dynamics monitor (paper Section 3.1: "the task scheduler
continuously monitors for changes in training information, and upon
detecting change, activates an optimizer").

The plan-signature detection in ``scheduler.py`` covers declared changes
(batch schedule, NAS candidates); this monitor detects *undeclared* shifts
from noisy per-iteration observations — e.g. a data-dependent slowdown or
a platform regression — with an EWMA + CUSUM change detector, and tells
the scheduler to re-optimize.

A copy of the JAX package's ``core/monitor.py`` (numpy only): the same
arguments and seed give the same results, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ThroughputMonitor:
    """EWMA-normalized CUSUM on per-iteration throughput.

    z-scores are winsorized at ±z_clip so a single outlier iteration can
    add at most (z_clip - drift) to the CUSUM — alarms need *sustained*
    evidence; the slow EWMA keeps the baseline from chasing the shift
    before the CUSUM can accumulate it."""
    alpha: float = 0.05         # EWMA smoothing (slow baseline)
    # CUSUM slack = delta/2 for a target detectable shift of delta ~ 3
    # stddevs; under pure noise E[max(|z|-1.5, 0)] ~ 0.03/step, giving an
    # in-control ARL of ~250 iterations at threshold 8
    drift: float = 1.5
    threshold: float = 8.0      # CUSUM alarm level (in stddevs)
    z_clip: float = 4.0
    warmup: int = 5

    _mean: float = 0.0
    _var: float = 1.0
    _cusum_pos: float = 0.0
    _cusum_neg: float = 0.0
    _n: int = 0

    def observe(self, throughput: float) -> bool:
        """Feed one observation; returns True when a sustained shift is
        detected (and resets the detector)."""
        self._n += 1
        if self._n == 1:
            self._mean = throughput
            return False
        prev_mean = self._mean
        prev_std = max(self._var ** 0.5, 1e-9)
        # winsorize the update too: the baseline stats must not chase a
        # suspected shift while the CUSUM is still accumulating evidence
        dev = float(np.clip(throughput - prev_mean,
                            -self.z_clip * prev_std,
                            self.z_clip * prev_std))
        self._mean = (1 - self.alpha) * self._mean + self.alpha * (
            prev_mean + dev)
        self._var = (1 - self.alpha) * self._var + self.alpha * dev ** 2
        if self._n <= self.warmup:
            return False
        std = max(self._var ** 0.5, 1e-9)
        z = float(np.clip((throughput - prev_mean) / std,
                          -self.z_clip, self.z_clip))
        self._cusum_pos = max(0.0, self._cusum_pos + z - self.drift)
        self._cusum_neg = max(0.0, self._cusum_neg - z - self.drift)
        if max(self._cusum_pos, self._cusum_neg) > self.threshold:
            self.reset(keep_mean=throughput)
            return True
        return False

    def reset(self, keep_mean: Optional[float] = None):
        self._cusum_pos = self._cusum_neg = 0.0
        self._n = 1
        if keep_mean is not None:
            self._mean = keep_mean
            self._var = max(self._var, 1e-9)

    @property
    def mean(self) -> float:
        return self._mean
