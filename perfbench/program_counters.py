"""Per-unit readings of the program's counters
(``repro_torch.core.spans.count``), for the metrics that price a span's
time by the work the program counted in it.

Counters record when the program's spans do: here, in the units
``trace.trace_units`` profiles after the window. Each record carries an
id from the spans' own sequence, so the records of the last
``run.trace["steps"]`` units are those after the marker span that ends
the unit before them (``program_spans.MARKERS``) and up to the last
marker. None where the run was not traced or the program keeps no such
counter (a program without ``spans.counted``).
"""
from __future__ import annotations

from perfbench import program_spans


def per_unit(run, name: str, kind: str):
    """The counter ``name``'s records summed over the last
    ``run.trace["steps"]`` units of the ``kind`` of work, a unit."""
    if run.trace is None:
        return None
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    if not hasattr(spans, "counted"):
        return None
    steps = run.trace["steps"]
    marks = [s.id for s in spans.finished()
             if s.name == program_spans.MARKERS[kind]]
    if len(marks) < steps + 1:
        return None
    lo, hi = marks[-steps - 1], marks[-1]
    got = [c.value for c in spans.counted()
           if c.name == name and lo < c.id <= hi]
    return sum(got) / steps if got else None
