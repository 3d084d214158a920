"""Named spans at the port's layer boundaries, recorded only while someone
is looking.

    with spans.span("adamw.update"):
        ...

A span is **off** unless a torch profiler is recording
(``torch.autograd.profiler._is_profiler_enabled``) or the caller is inside
``recording()``. Off, ``span`` makes one check and returns a shared null
context: it allocates nothing and records nothing, so the untimed and the
timed program run the same operations.

**On**, a span opens a profiler range of its name, so under a profiler it
is a named host range in the trace, on the trace's own clock (the device
trace's), beside the kernels it launched. The range is an operator's
(``torch._C._profiler._RecordFunctionFast``), not a user annotation's
(``torch.profiler.record_function``): the profiler copies each user
annotation onto the device's timeline, from the first kernel launched
inside it to the last, and a summary of the device's busy time would
count that copy as busy, idle gaps included. A span also keeps its own
record: its parent (the innermost span open when it started, on the
one stack of the process), ``time.perf_counter_ns`` at both ends, and,
once CUDA is in use, a ``torch.cuda.Event`` recorded on the current stream
at both ends. ``finished()`` resolves a span's device milliseconds from
its two events: the device time between the points where the span began
and ended its work on the stream, so it counts any stretch in which the
stream waited for the host inside the span. Without CUDA it is the host's
milliseconds.

Spans in the port (the metric that reads each is in PERF.md):

- ``autograd.forward``, ``autograd.backward``: ``core/tree.py::
  value_and_grad``;
- ``exchange.flatten``, ``exchange.aggregate``: ``serverless/worker.py::
  LocalWorkerPool``;
- ``exchange.reduce_scatter``, ``exchange.all_gather``: ``launch/steps.py::
  TrainStep.__call__``;
- ``adamw.update``: ``optim/adamw.py::AdamW.update``;
- ``loss.cross_entropy``: ``models/layers.py::cross_entropy``;
- ``serve.prefill``, ``serve.decode_step``: ``serving/engine.py::
  ServingEngine.serve_batch``;
- ``moe.route``, ``moe.experts``, ``moe.combine``: ``models/moe.py::
  dropless_moe`` (the router, top-k, sort and gather of the pairs; the
  grouped expert products; the weighted f32 scatter-add).

**Counters** sit beside the spans and are on when they are: ``count(name,
value)`` keeps a record of ``value`` with an id from the spans' own
sequence, so that a reader can tell which span (and which unit of work)
each record falls in; ``counted()`` gives the records. The port's
counters: ``moe.pairs_held`` (the (token, slot) pairs routed to the
experts this layer holds), ``moe.pairs_busiest`` (the pairs of the
busiest of them) and ``moe.pairs_dropped`` (those pairs less the rows
the expert products gave back: 0 in a dropless layer), one record each a
layer, in ``dropless_moe``.

The records are kept in memory, at most ``CAP`` spans and ``CAP``
counter records: past that the oldest are dropped, and ``dropped()``
counts them.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import List, NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

CAP = 16384                     # closed spans kept; the oldest go first

_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    parent: Optional[int]       # the id of the span it ran inside
    name: str
    host_start_ns: int          # time.perf_counter_ns
    host_end_ns: int
    device_ms: float


class Count(NamedTuple):
    id: int                     # from the spans' sequence of ids
    name: str
    value: int


class _Recorder:
    """The process's spans: those open (a stack of ids) and those closed,
    each closed one as [id, parent, name, host start, host end, device ms
    or None, start event, end event] until ``finished`` resolves it; and
    the counters' records."""

    def __init__(self):
        self.depth = 0          # recording() blocks entered
        self.next_id = 0
        self.open: List[int] = []
        self.closed = collections.deque(maxlen=CAP)
        self.counts = collections.deque(maxlen=CAP)
        self.dropped = 0


_rec = _Recorder()


def on() -> bool:
    """Whether spans (and counters) record now."""
    return bool(_rec.depth or _autograd_profiler._is_profiler_enabled)


def span(name: str):
    """A context manager that records the span ``name`` while spans are on
    (see the module docstring), and does nothing otherwise."""
    if not (_rec.depth or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def count(name: str, value: int) -> None:
    """A record of ``value`` for the counter ``name`` while spans are on;
    nothing otherwise."""
    if not on():
        return
    r = _rec
    if len(r.counts) == CAP:
        r.dropped += 1
    r.counts.append(Count(r.next_id, name, int(value)))
    r.next_id += 1


def counted() -> List[Count]:
    """The counters' records kept, in the order they were made."""
    return list(_rec.counts)


@contextlib.contextmanager
def recording():
    """Spans are on inside the block, with or without a profiler."""
    _rec.depth += 1
    try:
        yield
    finally:
        _rec.depth -= 1


class _Span:
    __slots__ = ("name", "id", "parent", "range", "t0", "e0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        r = _rec
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        self.id, r.next_id = r.next_id, r.next_id + 1
        self.parent = r.open[-1] if r.open else None
        r.open.append(self.id)
        self.e0 = _event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        e1 = _event()
        r = _rec
        r.open.remove(self.id)
        if len(r.closed) == CAP:
            r.dropped += 1
        r.closed.append([self.id, self.parent, self.name, self.t0, t1, None,
                         self.e0, e1])
        self.range.__exit__(*exc)
        return False


def _event():
    if not torch.cuda.is_initialized():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def finished() -> List[Span]:
    """The closed spans kept, in the order they started. Synchronises the
    device once, where a span still holds events."""
    closed = _rec.closed
    if any(c[6] is not None for c in closed):
        torch.cuda.synchronize()
    for c in closed:
        if c[5] is None:
            c[5] = (c[6].elapsed_time(c[7]) if c[6] is not None
                    else (c[4] - c[3]) / 1e6)
            c[6] = c[7] = None
    return [Span(*c[:6]) for c in sorted(closed, key=lambda c: c[0])]


def clear():
    """Drop the closed spans and the counters' records, and the count of
    those dropped."""
    _rec.closed.clear()
    _rec.counts.clear()
    _rec.dropped = 0


def dropped() -> int:
    """Closed spans and counter records dropped past ``CAP`` since the last
    ``clear``."""
    return _rec.dropped
