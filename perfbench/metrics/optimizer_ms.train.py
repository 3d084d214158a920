"""Device milliseconds of AdamW a training step: the program's
``adamw.update`` span (``optim/adamw.py::AdamW.update``, the clip
included; on the ``hier`` step's shards), over the profiled units
(``perfbench/program_spans.py``)."""
from perfbench import program_spans


def read(run):
    return program_spans.per_unit_ms(run, ["adamw.update"], "train")
