"""Device milliseconds of the backward a training step: the program's
``autograd.backward`` spans (``core/tree.py::value_and_grad``; the pool's
four workers summed), over the profiled units
(``perfbench/program_spans.py``)."""
from perfbench import program_spans


def read(run):
    return program_spans.per_unit_ms(run, ["autograd.backward"], "train")
