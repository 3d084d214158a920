"""Percent of the traced window in which no operation ran on the device:
1 - (the union of the device's busy intervals) / (the window), from the
profiler's trace, the profiler's first cycle left out."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
