"""Percent of their roofline that the routed experts' products reach: the
least time of the two products of every held (token, slot) pair the
program counted (``moe.pairs_held``), d x 2f and then f x d, at the bf16
peak, or the held experts' weights read once a layer and each pair's row
in, hidden out, activation in and row out (bf16) at the memory rate,
whichever is longer, over the device time of the program's
``moe.experts`` spans (the grouped products and the SwiGLU between
them), an evaluation."""
from perfbench import program_counters, program_spans, yardstick


def bound_s(pairs: float, layers: int, held: int, d: int, f: int) -> float:
    flops = 6.0 * pairs * d * f
    io = 2 * (layers * held * 3 * d * f + pairs * (2 * d + 3 * f))
    return max(flops / yardstick.PEAK_BF16_FLOPS,
               io / yardstick.PEAK_HBM_BYTES)


def read(run):
    ms = program_spans.per_unit_ms(run, ["moe.experts"], "score")
    pairs = program_counters.per_unit(run, "moe.pairs_held", "score")
    if not ms or not pairs:
        return None
    m = run.model
    held = m.get("experts_held") or m["n_experts"]
    least = bound_s(pairs, m["n_layers"], held, m["d_model"], m["d_ff"])
    return 100.0 * least / (ms / 1e3)
