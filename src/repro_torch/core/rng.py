"""Named, independent random streams for every stochastic subsystem.

The repo draws randomness in several places — the event engine's
per-fleet straggler/failure draws, the correlated-shock process, the
platform's independent failure coin, the scheduler's BO loop, the
tuner's synthetic learning curves. Historically each site rolled its
own ``np.random.RandomState(<ad-hoc formula>)``; this module is the
one place those formulas live, with two families of constructors:

**Legacy streams** (``shock_stream``, ``worker_stream``,
``curve_stream``, ``base_stream``) reproduce the exact seed formulas
the engine/tuner/scheduler have always used, bit-for-bit — moving the
seeding here is a pure relocation, so golden traces and seeded tests
are unchanged.

**Hashed streams** (``stream``) derive a well-mixed 31-bit seed from a
``(seed, name, *keys)`` tuple via a splitmix64-style mixer. New code
(e.g. the engine's vectorized per-epoch draw blocks) uses these: the
string name documents what the stream feeds, and distinct names give
statistically independent streams even for adjacent integer seeds.

All constructors return the legacy ``np.random.RandomState`` (MT19937)
so draw-for-draw reproducibility is well-defined across numpy versions.
"""
from __future__ import annotations

import numpy as np

__all__ = ["stream", "stream_seed", "worker_stream", "shock_stream",
           "curve_stream", "base_stream"]

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a cheap, well-distributed 64-bit mixer."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, name: str, *keys: int) -> int:
    """A 31-bit seed derived from ``(seed, name, *keys)``.

    Deterministic across processes and platforms (no use of ``hash``),
    and well-mixed: streams for adjacent seeds or key values do not
    overlap in any detectable way. ``name`` labels the consumer
    ("straggler", "failure", ...), extra integer ``keys`` split it
    further (e.g. per job index).
    """
    h = _mix64(seed & _MASK64)
    for ch in name.encode("utf-8"):
        h = _mix64(h ^ ch)
    for k in keys:
        h = _mix64(h ^ (k & _MASK64))
    return h % (2 ** 31)


def stream(seed: int, name: str, *keys: int) -> np.random.RandomState:
    """An independent named stream: ``stream(seed, "straggler", job)``."""
    return np.random.RandomState(stream_seed(seed, name, *keys))


# -- legacy formulas (bit-exact relocations; do not change) ------------------

def worker_stream(seed: int, wid: int, job_idx: int = 0) \
        -> np.random.RandomState:
    """The event engine's historical per-worker stream (scalar straggler
    z / failure-u / failure-fraction draws, interleaved per attempt)."""
    return np.random.RandomState(
        (seed * 1_000_003 + wid + 611_953 * job_idx) % 2 ** 31)


def shock_stream(seed: int, job_idx: int = 0) -> np.random.RandomState:
    """The correlated-shock process (inter-arrival + kill coins)."""
    return np.random.RandomState(
        (seed * 2_147_483_029 + 97 + job_idx) % 2 ** 31)


def curve_stream(sweep_seed: int) -> np.random.RandomState:
    """The tuner's synthetic learning-curve generator."""
    return np.random.RandomState(sweep_seed * 9176 + 13)


def base_stream(seed: int) -> np.random.RandomState:
    """A plain ``RandomState(seed)`` — the scheduler's BO loop, the
    platform's failure coin. Kept as a named constructor so every
    seeding site routes through this module."""
    return np.random.RandomState(seed)
