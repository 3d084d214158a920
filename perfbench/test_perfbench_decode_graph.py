"""The reader of ``decode_graph_share.serve`` on planted span and counter
records: it takes the traced batches' counts (the last ``steps``
batches, each counted after its ``serve.prefill`` span), and finds nothing
without the program's counters, without a trace or without device work."""
from __future__ import annotations

import types

import pytest

from perfbench.harness import load_file
from perfbench._testing import REPO

READER = load_file(REPO / "perfbench" / "metrics"
                   / "decode_graph_share.serve.py", "decode_graph_share")


def _plant(monkeypatch, batches):
    """One batch of the serve loop a (replayed, eager) pair: its prefill
    span, three decode step spans, then its two counter records."""
    from repro_torch.core import spans
    recs, counts, i = [], [], 0
    for replayed, eager in batches:
        for name in ["serve.prefill"] + ["serve.decode_step"] * 3:
            recs.append(spans.Span(i, None, name, 0, 0, 1.0))
            i += 1
        for name, v in (("serve.decode_replayed", replayed),
                        ("serve.decode_eager", eager)):
            if v is not None:
                counts.append(spans.Count(i, name, v))
                i += 1
    monkeypatch.setattr(spans, "finished", lambda: recs)
    monkeypatch.setattr(spans, "counted", lambda: counts)


def _run(steps=2, busy_s=1.0):
    return types.SimpleNamespace(trace={"steps": steps, "busy_s": busy_s})


@pytest.mark.parametrize("batches,want", [
    ([(31, 0)] * 3, 100.0),
    ([(0, 31)] * 3, 0.0),
    # the profiler's first cycle (eager here) is left out
    ([(0, 31), (31, 0), (31, 0)], 100.0),
    ([(0, 3), (3, 0), (0, 3)], 50.0),
])
def test_share_of_the_traced_batches(monkeypatch, batches, want):
    _plant(monkeypatch, batches)
    assert READER.read(_run()) == pytest.approx(want)


def test_nothing_to_read(monkeypatch):
    _plant(monkeypatch, [(None, None)] * 3)      # a program without them
    assert READER.read(_run()) is None
    _plant(monkeypatch, [(31, 0)] * 3)
    assert READER.read(types.SimpleNamespace(trace=None)) is None
    assert READER.read(_run(busy_s=0.0)) is None     # no device work
    assert READER.read(_run(steps=4)) is None        # too few batches
    _plant(monkeypatch, [(0, 0)] * 3)               # no decode step
    assert READER.read(_run()) is None
