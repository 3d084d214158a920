"""Tensor parallelism over the ``model`` axis for the hybrid, vlm and
audio families on 4 gloo ranks (``tests/torch_dist_checks.py`` suite
``tpf4``, one spawn for the file under a hard deadline), from the
reference's init(key 0) of reduced configs:

- each ``TP_FAMILY_MESHES`` case on (model 4) and on (data 2, model 2):
  each rank's logits (rtol 1e-4 / atol 5e-5), the global batch's loss
  (rtol 1e-5) and every gradient gathered back to the whole leaf (rtol
  5e-4 / atol 1e-5) against the reference's on one device
  (``tests/torch_tp_ref.py``). On 4 ranks each rank runs one of reduced
  zamba2's, llama-vision's and seamless's 4 heads; zamba2 with 2 KV heads
  splits its ring's head dims; olmo-1b runs under ``seq_shard``;
- the prefill and serve steps of zamba2 with 2 KV heads on (model 4)
  against world size 1, a prompt of 40 tokens wrapping its ring of 32:
  each rank holds 8 of every KV head's 32 dims, and decode sums the
  partial scores over the group."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as dc  # noqa: E402
import torch_tp_ref as ref  # noqa: E402
from test_torch_tp_families2 import check_steps  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tpf4"))
    ref.write_inits(work, sorted(set(dc.TP_FAMILY_MESHES["1x4"])
                                 | set(dc.TP_FAMILY_MESHES["2x2"])))
    dc.run_world("tpf4", 4, work, timeout=300)
    return [dc.load(work, f"tpf4_rank{r}") for r in range(4)]


@pytest.mark.parametrize("case", dc.TP_FAMILY_MESHES["1x4"])
def test_model4_family_matches_reference(ranks, case):
    for r in ranks:
        ref.check_case(r, f"1x4/{case}", case)


@pytest.mark.parametrize("case", dc.TP_FAMILY_MESHES["2x2"])
def test_data2_model2_family_matches_reference(ranks, case):
    for r in ranks:
        ref.check_case(r, f"2x2/{case}", case)


@pytest.mark.parametrize("case", dc.TP_FAMILY_STEP_MESHES["1x4"])
def test_prefill_and_serve_steps_model4_equal_world1(ranks, case):
    key = f"steps1x4/{case}"
    check_steps(ranks, key)
    assert f"(2, {dc.TP_BATCH}, 32, 2, 8)" in str(
        ranks[0][f"{key}/cache_shapes"])
