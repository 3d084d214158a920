"""Milliseconds of prefill a thousand prompt tokens: the engine's own
prefill seconds (``ServingEngine.last_stats``) over the prompt tokens,
summed over every batch of the window."""


def read(run):
    c = run.counters
    return 1e6 * c["prefill_s"] / c["prompt_tokens"] if c.get(
        "prompt_tokens") else None
