"""Device milliseconds of the loss an evaluation: the program's
``loss.cross_entropy`` span (``models/layers.py::cross_entropy``: the f32
cast of the logits, the padding mask, the log-sum-exp and the gold
logits), over the profiled units (``perfbench/program_spans.py``)."""
from perfbench import program_spans


def read(run):
    return program_spans.per_unit_ms(run, ["loss.cross_entropy"], "score")
