"""Milliseconds of ``LocalWorkerPool.step`` a training step (the workers'
forward and backward, flatten, shard, aggregate, join): the benchmark's
host-clock span around the call, synchronised at both ends, averaged over
the traced run's window."""


def read(run):
    s = run.spans.get("pool.step")
    return 1e3 * sum(s) / len(s) if s else None
