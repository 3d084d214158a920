"""Percent of the traced batches' decode steps that the serving engine
replayed as one captured CUDA graph: the program's counters
``serve.decode_replayed`` over it and ``serve.decode_eager``, summed over
the last ``run.trace["steps"]`` batches (those from the last
``serve.prefill`` spans on: the engine counts a batch after its prefill).
None where the program keeps no such counter, and in a run with no device
work traced (the CPU tests'), where there is no graph to replay."""
COUNTERS = ("serve.decode_replayed", "serve.decode_eager")


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
    got = {n: [c.value for c in spans.counted()
               if c.name == n and c.id > marks[-steps]] for n in COUNTERS}
    if not all(got.values()):
        return None
    replayed, eager = (sum(got[n]) for n in COUNTERS)
    return 100.0 * replayed / (replayed + eager) if replayed + eager else None
