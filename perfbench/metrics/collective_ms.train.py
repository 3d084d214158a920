"""Device milliseconds of the ``hier`` step's collectives a training step:
the program's ``exchange.reduce_scatter`` span (each gradient leaf
scattered or all-reduced, and divided) and its ``exchange.all_gather``
span (the updated parts gathered, the loss all-reduced), in
``launch/steps.py::TrainStep.__call__``, over the profiled units
(``perfbench/program_spans.py``)."""
from perfbench import program_spans


def read(run):
    return program_spans.per_unit_ms(
        run, ["exchange.reduce_scatter", "exchange.all_gather"], "train")
