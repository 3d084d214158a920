"""Percent of its roofline that the flash-attention backward reaches: the
least time of attention's backward at the cell's shapes (five products
over the visible causal pairs at the bf16 peak, or q, k, v, out, dO, dq,
dk, dv in bf16 and the f32 logsumexp moved once at the memory rate,
whichever is longer), for every layer of every worker of every traced
step, over the device time of the kernels that implement it."""
from perfbench import trace, yardstick

KERNELS = r"bwd_(prep|dkdv|dq)"


def bound_s(b: int, h: int, s: int, d: int) -> float:
    pairs = s * (s + 1) / 2
    flops = 10.0 * b * h * d * pairs
    io = 8 * b * h * s * d * 2 + b * h * s * 4
    return max(flops / yardstick.PEAK_BF16_FLOPS,
               io / yardstick.PEAK_HBM_BYTES)


def read(run):
    if run.trace is None:
        return None
    spent = trace.kernel_seconds(run.trace, KERNELS)
    if not spent:
        return None
    m, t = run.model, run.traffic
    workers = t.get("workers", 1)
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    calls = run.trace["steps"] * m["n_layers"] * workers
    least = calls * bound_s(t["batch"] // workers, m["n_heads"], t["seq"], hd)
    return 100.0 * least / spent
