"""Milliseconds of device time in the elementwise kernel family
(``yardstick.FAMILIES``) a traced unit: a training step, an evaluation or
a served batch."""
from perfbench import trace


def read(run):
    if run.trace is None:
        return None
    fam = trace.family_seconds(run.trace).get("elementwise", 0.0)
    return 1e3 * fam / run.trace["steps"] if fam else None
