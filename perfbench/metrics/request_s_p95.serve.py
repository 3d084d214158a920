"""Seconds: the nearest-rank 95th percentile over every request
completed in the window, each timed from its batch's submission to its
completion (the benchmark's host clock). Not an end-to-end metric with a
bound: a request's latency follows the host's speed, which spreads by
11-20 % from run to run on the card's shared host (PERF.md)."""


def read(run):
    return run.counters.get("request_s_p95")
