"""Milliseconds a decode step: the engine's own decode seconds
(``ServingEngine.last_stats``) over its decode steps, summed over every
batch of the window."""


def read(run):
    c = run.counters
    return 1e3 * c["decode_s"] / c["decode_steps"] if c.get(
        "decode_steps") else None
