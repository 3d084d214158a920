"""Tensor parallelism over the ``model`` axis for the hybrid, vlm and
audio families, and sequence parallelism (``seq_shard``) for all six
families, on 2 gloo ranks (``tests/torch_dist_checks.py`` suite ``tpf2``,
one spawn for the file under a hard deadline), each rank on its model
parts of the reference's init(key 0) of a reduced config:

- each ``TP_FAMILY_MESHES["1x2"]`` case: its rows' logits (rtol 1e-4 /
  atol 5e-5), the loss (rtol 1e-5) and every gradient gathered back to the
  whole leaf (rtol 5e-4 / atol 1e-5), the norm scales' included, against
  the reference's on one device (``tests/torch_tp_ref.py``): reduced
  zamba2-7b (Mamba2 heads and the shared block's heads split),
  llama-3.2-vision-90b with its gates opened to 0.5 on both sides (one KV
  head: the cross K/V splits its dims, the scores summed over the group)
  and seamless-m4t-medium (encoder, decoder and cross K/V on their
  heads); and one ``seq_shard`` case of each of the six families, the
  stream split along the sequence between the layers;
- the prefill and serve steps of the three families on "1x2" against the
  same calls at world size 1: a prompt of 40 tokens (zamba2's ring of 32
  wraps) and 3 teacher-forced tokens, the last position's logits of each
  (rtol 1e-4 / atol 5e-5) and the caches gathered back, each rank's cache
  holding its part (the ring's and the cross K/V's kv heads, or their
  dims where the heads do not divide)."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as dc  # noqa: E402
import torch_tp_ref as ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

MESH = "1x2"


@pytest.fixture(autouse=True)
def _split_reduced_leaves(monkeypatch):
    monkeypatch.setattr(steps, "FSDP_MIN_SIZE", dc.FSDP_MIN_SIZE)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tpf2"))
    ref.write_inits(work, sorted(set(dc.TP_FAMILY_MESHES[MESH])))
    dc.run_world("tpf2", 2, work, timeout=300)
    return [dc.load(work, f"tpf2_rank{r}") for r in range(2)]


@pytest.mark.parametrize("case", dc.TP_FAMILY_MESHES[MESH])
def test_model2_family_matches_reference(ranks, case):
    for r in ranks:
        ref.check_case(r, f"{MESH}/{case}", case)


def check_steps(ranks, key):
    """Each rank's prefill and decode logits and its gathered caches
    against world size 1's."""
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/got"], r[f"{key}/want"],
                                   rtol=ref.LOGITS_RTOL,
                                   atol=ref.LOGITS_ATOL)
        pre = f"{key}/cache/"
        cache = [k for k in r if k.startswith(pre)]
        assert cache
        for k in cache:
            np.testing.assert_allclose(
                r[k], r[f"{key}/want_cache/{k[len(pre):]}"],
                rtol=ref.LOGITS_RTOL, atol=ref.LOGITS_ATOL, err_msg=k)


@pytest.mark.parametrize("case", dc.TP_FAMILY_STEP_MESHES[MESH])
def test_prefill_and_serve_steps_model2_equal_world1(ranks, case):
    key = f"steps{MESH}/{case}"
    check_steps(ranks, key)
    shapes = str(ranks[0][f"{key}/cache_shapes"])
    b, hd = dc.TP_BATCH, 32
    if case == "zamba2-7b":         # 2 rings of 32 slots, 2 of 4 kv heads
        assert f"(2, {b}, 32, 2, {hd})" in shapes
    elif case == "seamless-m4t-medium":  # cross K/V of 32 frames
        assert f"(2, {b}, 32, 2, {hd})" in shapes
    else:                            # one image KV head: its dims split
        assert f"(2, {b}, 16, 1, {hd // 2})" in shapes
