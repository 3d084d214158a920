"""Percent of its roofline that the SSD scan reaches: the least time of
the chunked scan at the cell's shapes (its operations at the bf16 peak, or
x, dt, A, B, C, D read once and y and the final state written once at the
memory rate, whichever is longer), for every layer of every traced
evaluation, over the device time of the kernels that implement it."""
from perfbench import trace, yardstick

KERNELS = r"ssd_scan(_wgmma)?_kernel"


def bound_s(b: int, s: int, h: int, p: int, n: int, chunk: int) -> float:
    nc, q = s // chunk, chunk
    flops = b * nc * n * q * (q + 1) + b * h * nc * (
        p * q * (q + 1) + 4 * q * n * p)
    io = (2 * b * s * h * p * 2          # x in, y out (bf16)
          + b * s * h * 4 + h * 4        # dt (f32), A (f32)
          + 2 * b * s * n * 2 + h * 2    # B, C (bf16), D (bf16)
          + b * h * n * p * 4)           # the final state (f32)
    return max(flops / yardstick.PEAK_BF16_FLOPS,
               io / yardstick.PEAK_HBM_BYTES)


def read(run):
    if run.trace is None:
        return None
    spent = trace.kernel_seconds(run.trace, KERNELS)
    if not spent:
        return None
    m, t = run.model, run.traffic
    di = m["ssm_expand"] * m["d_model"]
    calls = run.trace["steps"] * m["n_layers"]
    least = calls * bound_s(t["batch"], t["seq"], di // m["ssm_headdim"],
                            m["ssm_headdim"], m["ssm_state"], m["ssm_chunk"])
    return 100.0 * least / spent
