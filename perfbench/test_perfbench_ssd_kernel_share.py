"""The reader of ``ssd_kernel_share.serve`` on planted span and counter
records: the share of the traced batches' SSD layers (the last ``steps``
batches, each counted inside its ``serve.prefill`` span) that counted
``ssd.kernel``, and nothing without the program's counters, without a
trace or without device work."""
from __future__ import annotations

import types

import pytest

from perfbench.harness import load_file
from perfbench._testing import REPO

READER = load_file(REPO / "perfbench" / "metrics"
                   / "ssd_kernel_share.serve.py", "ssd_kernel_share")
LAYERS = 4


def _plant(monkeypatch, batches):
    """One batch of the serve loop a list of the prefill's layers' counter
    names (None: a program without them): its prefill span, the layers'
    records inside it, then three decode step spans and the decode
    counters."""
    from repro_torch.core import spans
    recs, counts, i = [], [], 0
    for layers in batches:
        recs.append(spans.Span(i, None, "serve.prefill", 0, 0, 1.0))
        i += 1
        for name in layers:
            if name is not None:
                counts.append(spans.Count(i, name, 1))
                i += 1
        for _ in range(3):
            recs.append(spans.Span(i, None, "serve.decode_step", 0, 0, 1.0))
            i += 1
        for name in ("serve.decode_replayed", "serve.decode_eager"):
            counts.append(spans.Count(i, name, 3 if "replayed" in name
                                      else 0))
            i += 1
    monkeypatch.setattr(spans, "finished", lambda: recs)
    monkeypatch.setattr(spans, "counted", lambda: counts)


def _run(steps=2, busy_s=1.0):
    return types.SimpleNamespace(trace={"steps": steps, "busy_s": busy_s})


KERNEL = ["ssd.kernel"] * LAYERS
CHUNKED = ["ssd.chunked"] * LAYERS


@pytest.mark.parametrize("batches,want", [
    ([KERNEL] * 3, 100.0),
    ([CHUNKED] * 3, 0.0),
    # the batches before the traced ones are left out
    ([CHUNKED, KERNEL, KERNEL], 100.0),
    ([CHUNKED, KERNEL, ["ssd.kernel", "ssd.chunked"] * 2], 75.0),
    ([KERNEL, CHUNKED, KERNEL], 50.0),
])
def test_share_of_the_traced_batches(monkeypatch, batches, want):
    _plant(monkeypatch, batches)
    assert READER.read(_run()) == pytest.approx(want)


def test_nothing_to_read(monkeypatch):
    _plant(monkeypatch, [[None] * LAYERS] * 3)    # a program without them
    assert READER.read(_run()) is None
    _plant(monkeypatch, [KERNEL] * 3)
    assert READER.read(types.SimpleNamespace(trace=None)) is None
    assert READER.read(_run(busy_s=0.0)) is None     # no device work
    assert READER.read(_run(steps=4)) is None        # too few batches
