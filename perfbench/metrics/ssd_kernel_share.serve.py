"""Percent of the traced batches' Mamba2 SSD layers, outside the one-token
recurrence, that ran the hand-written SSD kernel: the program's counters
``ssd.kernel`` over it and ``ssd.chunked`` (one record a block call each),
summed over the last ``run.trace["steps"]`` batches (those from the last
``serve.prefill`` spans on: a batch's prefill counts inside its span).
None where the program keeps no such counter, and in a run with no device
work traced (the CPU tests'), where the kernel is its plain version."""
COUNTERS = ("ssd.kernel", "ssd.chunked")


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    if not hasattr(spans, "counted"):
        return None
    steps = run.trace["steps"]
    marks = [s.id for s in spans.finished() if s.name == "serve.prefill"]
    if len(marks) < steps:
        return None
    got = {n: sum(c.value for c in spans.counted()
                  if c.name == n and c.id > marks[-steps]) for n in COUNTERS}
    total = sum(got.values())
    return 100.0 * got["ssd.kernel"] / total if total else None
