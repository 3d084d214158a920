"""The port's dry run at full size on the 256-rank production mesh, on fake
CPU tensors (nothing is allocated; the trace holds a few hundred MB of
host memory): for olmo-1b and mistral-large-123b at ``train_4k``, the
analytic model's useful FLOPs over the traced per-rank FLOPs times 256
lie in (0, 1.01], as ``tests/test_dryrun_tools.py::test_useful_ratio_
bounded`` holds the reference's analytic terms. These two traces take
most of this file's time (mistral-large's 88 layers, with remat)."""
import pytest

torch = pytest.importorskip("torch")

from benchmarks import flops_model as FM  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro_torch.launch.dryrun import lower_one  # noqa: E402


@pytest.mark.parametrize("arch", ["olmo-1b", "mistral-large-123b"])
def test_useful_flops_ratio_bounded(arch):
    res = lower_one(arch, "train_4k", multi_pod=False, device="cpu")
    assert res["mesh"] == "256x1"
    useful = FM.model_flops_per_step(J_ARCHS[arch], "train_4k")
    assert 0 < useful / (res["flops"] * 256) <= 1.01, res["flops"]
