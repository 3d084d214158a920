"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything that belongs to one configuration, traffic mix, loop, per-layer
metric or cell limit is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

    configs/<config>.json     sizes of a model, as they are run
    traffic/<mix>.json        parameters of a traffic mix, and its loop
    loops/<loop>.py           what drives the program for a kind of mix
    metrics/<metric>.py       a reader of one per-layer metric
    limits/<cell>.json        the limits of the numbers a cell compares
    reference/<family>.py     plain PyTorch models that decide ``correct``

The yardstick (peaks, kernel families, FLOP counts, seeds, the fp8
control's rounding) is in ``yardstick.py``; the profiler summary in
``trace.py``; the run itself in ``harness.py``.
"""
