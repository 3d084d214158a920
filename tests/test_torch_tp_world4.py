"""Tensor parallelism over the ``model`` axis (ROADMAP A16b) on 4 gloo
ranks (``tests/torch_dist_checks.py`` suite ``tp4``, one spawn for the
file under a hard deadline), from the reference's init(key 0) of reduced
configs:

- every ``TP_CASES`` case on (model 4) and the ``TP_MESHES["2x2"]`` ones
  on (data 2, model 2): each rank's logits (rtol 1e-4 / atol 5e-5), the
  global batch's loss (rtol 1e-5) and every gradient gathered back to the
  whole leaf (rtol 5e-4 / atol 1e-5) against the reference's on one
  device (``tests/torch_tp_ref.py``). On 4 ranks phi4-mini with 6 heads
  splits wq inside a head (1.5 heads a rank, as phi4-mini's 24 heads on
  16), qwen2-moe's 4 experts are expert parallel, and with 6 experts
  the per-expert fallback runs; on (data 2, model 2) qwen2-moe dispatches
  in groups of one sequence, so that each data rank's rows make the
  global batch's groups;
- the reference's 40-step ``hier`` curve (``tests/test_torch_train.py``)
  through ``make_train_step`` on (data 2, model 2) at rtol 1e-4, with
  ZeRO-3 off and on, and on under remat "full" (the recompute runs the
  layer's model-group collectives again), and the whole moments after
  the first step at the
  reference's gradient tolerances (rtol 5e-4, atol 1e-5 of each leaf's
  largest). (After ten steps one of embed/tok's 131,072 first moments
  lies 6.2e-8 from the reference's, 1.7 times that atol: the f32 rounding
  of the vocabulary-parallel sums, in another order, carried by ten
  updates, as ``test_fsdp_gloo4_hybrid_matches_reference`` notes of the
  hybrid.)"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as dc  # noqa: E402
import torch_tp_ref as ref  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from test_torch_train import CURVE_RTOL, _close_to_ref, _leaves  # noqa: E402
from test_torch_train import _ref_steps  # noqa: E402


@pytest.fixture(scope="module")
def curve_ref():
    """The reference's train() curve and its moments after the first
    step."""
    cfg = j_reduced(J_ARCHS["olmo-1b"])
    _, curve = jtrain.train(cfg, steps=dc.TRAIN_STEPS, batch=dc.TRAIN_BATCH,
                            seq=dc.TRAIN_SEQ, strategy="hier",
                            log_every=dc.TRAIN_STEPS)
    return dict(_ref_steps("olmo-1b", 1), curve=np.array(curve))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tp4"))
    ref.write_inits(work, sorted(set(dc.TP_MESHES["1x4"])
                                 | set(dc.TP_MESHES["2x2"])))
    dc.run_world("tp4", 4, work, timeout=600)
    return [dc.load(work, f"tp4_rank{r}") for r in range(4)]


@pytest.mark.parametrize("case", dc.TP_MESHES["1x4"])
def test_model4_matches_reference(ranks, case):
    for r in ranks:
        ref.check_case(r, f"1x4/{case}", case)


@pytest.mark.parametrize("case", dc.TP_MESHES["2x2"])
def test_data2_model2_matches_reference(ranks, case):
    for r in ranks:
        ref.check_case(r, f"2x2/{case}", case)


@pytest.mark.parametrize("run", ["replicated", "fsdp", "fsdp_remat"])
def test_hier_curve_data2_model2_matches_reference(ranks, curve_ref, run):
    key = f"curve2x2/{run}"
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/curve"], curve_ref["curve"],
                                   rtol=CURVE_RTOL)
        _close_to_ref(_leaves(r, key, "full_mu"), curve_ref["mu"], "mu")
        _close_to_ref(_leaves(r, key, "full_nu"), curve_ref["nu"], "nu")
