"""Per-layer readings from the program's own spans
(``repro_torch.core.spans``), for the ``program_span`` metrics.

The program records its spans while a torch profiler records, so here only
in the units ``trace.trace_units`` profiles after the window: the first,
which the trace summary throws away (the profiler's first cycle), and
``run.trace["steps"]`` more. A reading is the spans of those last units:
a unit ends at its marker span (``adamw.update`` in training,
``loss.cross_entropy`` in scoring), and a name's spans a unit are counted
between the last two markers, so that a span that follows the marker in
its unit (the ``hier`` step's all-gather) is counted with its own unit.

A span's time is its device milliseconds: the CUDA events the span
records on the stream at its start and its end, so the device's clock,
between the points where the span's work began and ended. Where the
stream waits for the host inside a span, that wait is in the reading:
pool-train's traced units are ~10 % idle (ledger, PR 25), which inflates
the readings of its host-paced stretches. None where the program keeps
no spans (a program without ``core/spans.py``) or the run was not traced.
"""
from __future__ import annotations

MARKERS = {"train": "adamw.update", "score": "loss.cross_entropy"}


def per_unit_ms(run, names, kind: str):
    """Device milliseconds a unit of the spans called one of ``names``,
    over the last ``run.trace["steps"]`` units of the ``kind`` of work."""
    if run.trace is None:
        return None
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    got = spans.finished()
    steps = run.trace["steps"]
    marks = [s.id for s in got if s.name == MARKERS[kind]]
    if len(marks) < 2:
        return None
    total = 0.0
    for name in names:
        mine = [s for s in got if s.name == name]
        per = sum(marks[-2] < s.id <= marks[-1] for s in mine)
        if not per or len(mine) < per * steps:
            return None
        total += sum(s.device_ms for s in mine[-per * steps:])
    return total / steps
