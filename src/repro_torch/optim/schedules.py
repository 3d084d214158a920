"""LR schedules + the paper's dynamic *batch* schedulers (Section 3.2:
B = {b_1 ... b_n}, the per-epoch batch sizes of dynamic batching [23])."""
from __future__ import annotations

import math
from typing import Callable, List, Sequence


def warmup_cosine(warmup: int, total: int, floor: float = 0.1) -> Callable:
    """step -> lr multiplier: linear warmup, then cosine down to ``floor``
    (Python floats; the step counter is a Python int in the port)."""
    def f(step) -> float:
        step = float(step)
        if step < warmup:
            return step / max(warmup, 1)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t))
    return f


def constant(_step):
    return 1.0


# -- batch schedulers (B in the paper's notation) ---------------------------


def fixed_batch(b: int, epochs: int) -> List[int]:
    return [b] * epochs


def doubling_batch(b0: int, epochs: int, every: int = 2,
                   cap: int = 1 << 16) -> List[int]:
    """Worker-adaptive batch scaling a la [23]: double every ``every`` epochs."""
    out = []
    b = b0
    for e in range(epochs):
        if e and e % every == 0:
            b = min(b * 2, cap)
        out.append(b)
    return out


def step_batch(sizes: Sequence[int], epochs_per: int) -> List[int]:
    out = []
    for s in sizes:
        out += [s] * epochs_per
    return out
