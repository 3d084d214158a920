"""Percent of its roofline that the SSD scan reaches in a model whose
layers are not all Mamba2 (``layer_types``): ``ssd_scan_roofline.score``'s
least time at the cell's shapes, for every "mamba" layer of every traced
evaluation, over the device time of the kernels that implement it."""
from pathlib import Path

from perfbench import harness, trace

SCORE = harness.load_file(Path(__file__).with_name(
    "ssd_scan_roofline.score.py"), "perfbench_ssd_scan_roofline_score")


def read(run):
    if run.trace is None:
        return None
    spent = trace.kernel_seconds(run.trace, SCORE.KERNELS)
    if not spent:
        return None
    m, t = run.model, run.traffic
    di = m["ssm_expand"] * m["d_model"]
    calls = run.trace["steps"] * list(m["layer_types"]).count("mamba")
    least = calls * SCORE.bound_s(t["batch"], t["seq"],
                                  di // m["ssm_headdim"], m["ssm_headdim"],
                                  m["ssm_state"], m["ssm_chunk"])
    return 100.0 * least / spent
