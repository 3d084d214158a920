"""Percent of its roofline that the shard aggregation reaches: each
worker's f32 shard of the flat gradient read once and the mean written
once, at the memory rate, for every shard of every traced step, over the
device time of the aggregation kernel."""
import importlib
import math

from perfbench import trace, yardstick

KERNELS = r"agg_kernel"


def bytes_per_call(n_workers: int, n_params: int) -> int:
    shard = -(-n_params // n_workers)
    return (n_workers + 1) * shard * 4


def read(run):
    if run.trace is None:
        return None
    spent = trace.kernel_seconds(run.trace, KERNELS)
    if not spent:
        return None
    ref = importlib.import_module(
        f"perfbench.reference.{run.config['reference']}")
    params = sum(math.prod(shape) for _, shape, init in ref.spec(run.model)
                 if shape is not None)
    n = run.traffic["workers"]
    least = run.trace["steps"] * n * bytes_per_call(n, params) \
        / yardstick.PEAK_HBM_BYTES
    return 100.0 * least / spent
