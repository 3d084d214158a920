"""Percent of the card's bf16 peak that the window's work reaches in
model FLOPs: the loop's ``work`` counter (tokens of each kind and the
keys they attend to) priced by the configuration file's
``flops_per_token`` (``yardstick.model_flops``: the published shapes, no
recomputation, no padding), over the run's whole window on the host
clock."""
from perfbench import yardstick


def read(run):
    flops = yardstick.model_flops(run.config, run.counters.get("work"))
    if not flops:
        return None
    return 100.0 * flops / (run.window_s * yardstick.PEAK_BF16_FLOPS)
