"""Device milliseconds of the routed experts an evaluation: the program's
``moe.route`` (router, top-k, the held pairs sorted and gathered),
``moe.experts`` (the grouped products) and ``moe.combine`` (the gated
scatter-add in f32) spans of ``models/moe.py::dropless_moe``, every
layer, over the profiled units (``perfbench/program_spans.py``)."""
from perfbench import program_spans


def read(run):
    return program_spans.per_unit_ms(
        run, ["moe.route", "moe.experts", "moe.combine"], "score")
