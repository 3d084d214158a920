"""Milliseconds of ``AdamW.update`` a training step: the benchmark's
host-clock span around the call, synchronised at both ends, averaged over
the traced run's window."""


def read(run):
    s = run.spans.get("adamw.update")
    return 1e3 * sum(s) / len(s) if s else None
