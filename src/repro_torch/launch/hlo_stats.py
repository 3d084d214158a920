"""Collective statistics of a step (the port's counterpart of the JAX
package's ``launch/hlo_stats.py``).

The reference reads its collectives from the compiled HLO text. The port
has no HLO: every collective it issues goes through
``core/hier_sync.py``'s ``reduce_scatter``, ``all_gather`` and
``all_reduce``, which report each call to the recorders open here: those
of the data group and, under tensor parallelism
(``distributed/tensor_parallel.py``), those of the model group alike.

    with CollectiveRecorder() as rec:
        step(params, opt_state, batch)
    rec.stats()   # {"all-gather": {"count": 4, "bytes": 8192.0}, ...}

Ops carry the reference's names (``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``) and bytes its
convention: the size of the result operand, so a reduce-scatter counts
its 1/n result and an all-gather its full one. As the reference notes,
that is a proxy for the wire traffic (a ring all-reduce moves about twice
its result); it is for the op mix and for comparing two programs.
"""
from __future__ import annotations

from typing import Dict, List

OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")

_OPEN: List["CollectiveRecorder"] = []


def record(op: str, result) -> None:
    """Count one collective ``op`` whose result operand is the tensor
    ``result``, in every open recorder."""
    if op not in OPS:
        raise ValueError(f"unknown collective {op!r}; one of {OPS}")
    if _OPEN:
        nbytes = result.numel() * result.element_size()
        for rec in _OPEN:
            d = rec.ops.setdefault(op, {"count": 0, "bytes": 0.0})
            d["count"] += 1
            d["bytes"] += nbytes


class CollectiveRecorder:
    """A context that counts the collectives issued while it is open
    (recorders nest; each sees every call)."""

    def __init__(self):
        self.ops: Dict[str, Dict[str, float]] = {}

    def __enter__(self):
        _OPEN.append(self)
        return self

    def __exit__(self, *exc):
        _OPEN.remove(self)
        return False

    def stats(self) -> Dict[str, Dict[str, float]]:
        """{op: {"count", "bytes"}} for the ops seen, as the reference's
        ``collective_stats``."""
        return {op: dict(d) for op, d in self.ops.items()}
