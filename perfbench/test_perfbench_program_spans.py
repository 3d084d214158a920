"""The ``program_span`` metrics on the CPU, at the tiny sizes: a traced run
of each cell reports every one that BENCHMARK.json lists for the cell, each
above 0; the reader of the program's spans keeps the last profiled units
of each name and finds nothing without the program's spans."""
from __future__ import annotations

import json
import types

import pytest

from perfbench import program_spans
from perfbench._testing import REPO, run, tiny_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _listed(cell):
    return {m["name"] for m in BENCH["per_layer"]
            if m["source"] == "program_span" and cell in m["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_every_program_span_metric(root, cell):
    r = run(root, cell, trace=True)
    assert r["correct"], r["checks"]
    want = _listed(cell)
    assert want
    got = {k: v["value"] for k, v in r["metrics"].items() if k in want}
    assert set(got) == want
    assert all(v > 0 for v in got.values()), got


def test_every_new_span_metric_has_a_cell():
    for name in ("forward_ms.train", "backward_ms.train",
                 "pool_exchange_ms.train", "collective_ms.train",
                 "optimizer_ms.train", "cross_entropy_ms.score"):
        assert any(name in _listed(c) for c in CELLS), name


def _fake(monkeypatch, names, steps=2):
    """The program's ``finished()`` replaced by spans of ``names`` in
    turn, one device millisecond times their place each."""
    from repro_torch.core import spans
    recs = [spans.Span(i, None, n, 0, 0, float(i)) for i, n in
            enumerate(names)]
    monkeypatch.setattr(spans, "finished", lambda: recs)
    return types.SimpleNamespace(trace={"steps": steps})


def test_reader_counts_a_span_after_the_marker_with_its_unit(monkeypatch):
    # three hier units, the first the profiler's first cycle: F B A G each
    unit = ["autograd.forward", "autograd.backward", "adamw.update",
            "exchange.all_gather"]
    run_ = _fake(monkeypatch, unit * 3)
    # the last two units' gathers are spans 7 and 11
    assert program_spans.per_unit_ms(
        run_, ["exchange.all_gather"], "train") == (7 + 11) / 2
    assert program_spans.per_unit_ms(
        run_, ["autograd.forward", "adamw.update"], "train") == (
        4 + 8 + 6 + 10) / 2


def test_reader_finds_nothing_without_its_spans(monkeypatch):
    run_ = _fake(monkeypatch, ["loss.cross_entropy"] * 3)
    assert program_spans.per_unit_ms(run_, ["adamw.update"],
                                     "train") is None
    assert program_spans.per_unit_ms(types.SimpleNamespace(trace=None),
                                     ["loss.cross_entropy"], "score") is None
    run_ = _fake(monkeypatch, ["loss.cross_entropy"])     # one unit only
    assert program_spans.per_unit_ms(run_, ["loss.cross_entropy"],
                                     "score") is None
