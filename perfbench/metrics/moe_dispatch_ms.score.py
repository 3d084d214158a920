"""Device milliseconds of the routed experts' dispatch an evaluation: the
program's ``moe.route`` and ``moe.combine`` spans
(``models/moe.py::dropless_moe``: everything of the layer but the
grouped products), every layer, over the profiled units
(``perfbench/program_spans.py``)."""
from perfbench import program_spans


def read(run):
    return program_spans.per_unit_ms(run, ["moe.route", "moe.combine"],
                                     "score")
