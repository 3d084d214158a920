"""Device milliseconds of the pool's gradient exchange a training step:
the program's ``exchange.flatten`` spans (each worker's gradient into one
f32 vector) and its ``exchange.aggregate`` span (shards, the parameter
store, the aggregation kernel, the join and the cast back), in
``serverless/worker.py::LocalWorkerPool``, over the profiled units
(``perfbench/program_spans.py``)."""
from perfbench import program_spans


def read(run):
    return program_spans.per_unit_ms(
        run, ["exchange.flatten", "exchange.aggregate"], "train")
