"""The yardstick's own arithmetic, and the seeded traffic, on the CPU."""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from perfbench import harness, yardstick
from perfbench._testing import REPO
from perfbench.harness import load_file
from perfbench.loops import serve, training
from perfbench.reference import dense, ssm

METRICS = REPO / "perfbench" / "metrics"


def config(name):
    return json.loads((REPO / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


# ---------------------------------------------------------------------------
# the model FLOPs a configuration file states, against formulas written
# from the published shapes (no recomputation, no padding; a causal
# sequence of s tokens attends to s(s+1)/2 keys)
# ---------------------------------------------------------------------------


def dense_flops(m: dict) -> dict:
    hd = m.get("head_dim", m["d_model"] // m["n_heads"])
    d, L = m["d_model"], m["n_layers"]
    attn = d * m["n_heads"] * hd * 2 + d * m["n_kv_heads"] * hd * 2
    params = L * (attn + 3 * d * m["d_ff"]) + m["vocab_size"] * d
    head, key = 2 * m["vocab_size"] * d, 4 * L * m["n_heads"] * hd
    fwd = {"per_token": 2 * params, "per_key": key}
    return {"train": {"per_token": 6 * params, "per_key": 3 * key},
            "score": fwd, "decode": fwd,
            "prefill": {"per_token": 2 * params - head, "per_key": key},
            "head": {"per_token": head, "per_key": 0}}


def ssm_parts(m: dict):
    d = m["d_model"]
    di = m["ssm_expand"] * d
    n, p, q = m["ssm_state"], m["ssm_headdim"], m["ssm_chunk"]
    nh = di // p
    layer = d * (2 * di + 2 * n + nh) + di * d
    head = m["vocab_size"] * d
    conv = 2 * m["ssm_conv_width"] * (di + 2 * n)
    # the chunked scan: C B^T on the causal pairs of a chunk (shared by the
    # heads), then per head scores @ (x dt), C @ state and the state update
    scan = n * (q + 1) + nh * (p * (q + 1) + 4 * n * p)
    # one token of the recurrence: decay and B (x dt) into the state, C . S
    step = 5 * n * p * nh
    return layer, head, conv, scan, step


def ssm_flops(m: dict) -> dict:
    layer, head, conv, scan, step = ssm_parts(m)
    L = m["n_layers"]
    body = L * (2 * layer + conv)
    score = body + L * scan + 2 * head
    per = {"train": 3 * score, "score": score, "prefill": body + L * scan,
           "decode": body + L * step + 2 * head, "head": 2 * head}
    return {k: {"per_token": v, "per_key": 0} for k, v in per.items()}


def test_olmo_1b_step_flops():
    c = config("olmo-1b")
    assert dense_flops(c["model"])["train"]["per_token"] == 6 * 1_176_715_264
    step = yardstick.model_flops(c, {"train": {
        "tokens": 8 * 2048, "keys": 8 * yardstick.causal_keys(2048)}})
    assert round(step / 1e12, 1) == 122.3


@pytest.mark.parametrize("name,formula", [("olmo-1b", dense_flops),
                                          ("mamba2-2.7b", ssm_flops)])
def test_config_flops_are_the_formulas(name, formula):
    c = config(name)
    assert c["flops_per_token"] == formula(c["model"])


def test_mamba2_flops_parts():
    m = config("mamba2-2.7b")["model"]
    layer, head, conv, scan, step = ssm_parts(m)
    assert 64 * layer + head == 2_700_341_760
    assert scan == 3_970_176 and conv == 43_008 and step == 3_276_800


def test_model_flops_reads_only_the_config():
    """No family is known to the yardstick: a configuration of any family
    is priced by its own file, and a kind it gives no count for is
    silent."""
    c = {"model": {"family": "never-seen"},
         "flops_per_token": {"score": {"per_token": 10, "per_key": 3}}}
    assert yardstick.model_flops(c, {"score": {"tokens": 4, "keys": 6}}) \
        == 58
    assert yardstick.model_flops(c, {"train": {"tokens": 4, "keys": 6}}) \
        is None
    assert yardstick.causal_keys(4) == 10


def test_flash_bwd_bound():
    mod = load_file(METRICS / "flash_bwd_roofline.train.py", "fb")
    assert round(mod.bound_s(8, 16, 2048, 128) * 1e3, 4) == 0.3476


def test_ssd_scan_bound():
    mod = load_file(METRICS / "ssd_scan_roofline.score.py", "ssd")
    assert round(mod.bound_s(8, 2048, 80, 64, 128, 256) * 1e3, 4) == 0.1105


def test_aggregation_bytes():
    mod = load_file(METRICS / "hier_agg_roofline.train.py", "agg")
    assert mod.bytes_per_call(4, 1_279_787_008) == 6_398_935_040
    # the tied olmo-1b: the published 1,176,764,416 parameters
    n_params = sum(math.prod(s) for _, s, _ in
                   dense.spec(config("olmo-1b")["model"]) if s is not None)
    assert n_params == 1_176_764_416
    assert mod.bytes_per_call(4, n_params) == 5_883_822_080


@pytest.mark.parametrize("name,ref", [("olmo-1b", dense),
                                      ("mamba2-2.7b", ssm)])
def test_reference_layout_is_the_programs(name, ref):
    from repro_torch.core import tree as T
    from repro_torch.models import registry
    c = config(name)
    cfg = harness.model_config(c)
    want = {p: tuple(x.shape) for p, x in T.leaves_with_path(
        registry.init(0, cfg, device="meta"))}
    got = {p: s for p, s, i in ref.spec(c["model"]) if s is not None}
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == \
        registry.param_count(cfg)


class _Ctx:
    def __init__(self, cell, seed):
        b = harness.load_benchmark(REPO)
        self.cell = harness.find_cell(REPO, b, cell)
        self.seed, self.device = seed, torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 40 + 3])
def test_seeded_traffic_repeats(seed):
    a, b = _Ctx("olmo-1b.pool-train", seed), _Ctx("olmo-1b.pool-train",
                                                  seed + 1)
    a.cell.traffic.update(batch=2, seq=16)
    b.cell.traffic.update(batch=2, seq=16)
    x, y = training.batch(a, 3)["tokens"], training.batch(a, 3)["tokens"]
    assert torch.equal(x, y)
    assert not torch.equal(x, training.batch(a, 4)["tokens"])
    assert not torch.equal(x, training.batch(b, 3)["tokens"])
    s = _Ctx("mamba2-2.7b.serve", seed)
    assert np.array_equal(serve.prompts(s, 5), serve.prompts(s, 5))
    assert not np.array_equal(serve.prompts(s, 5)[:, :256],
                              serve.prompts(s, 9)[:, :256])


def test_serve_cycle_in_fixed_order():
    s = _Ctx("mamba2-2.7b.serve", 11)
    lens = [serve.prompts(s, i).shape for i in range(9)]
    assert [n for _, n in lens] == [256, 512, 1024, 2048] * 2 + [256]
    assert {b for b, _ in lens} == {8}


def test_worst_leaf_gap_by_the_median_leaf():
    ref = {"a": 10.0, "b": 1.0, "c": 1e-6}
    # a tiny leaf is held against the median leaf's norm, not its own
    assert yardstick.worst_leaf_gap({"a": 10.0, "b": 1.0, "c": 2e-6},
                                    ref) == pytest.approx(1e-6)
    assert yardstick.worst_leaf_gap({"a": 11.0, "b": 1.0, "c": 1e-6},
                                    ref) == pytest.approx(0.1)
    assert yardstick.moved_leaves(ref) == {"a", "b"}


def test_fp8_round_keeps_the_gradient():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = yardstick.fp8_round(x)
    assert not torch.equal(y.detach(), x.detach())
    assert (y.detach() - x.detach()).abs().max() <= 3 * 2 ** -4
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_families():
    assert yardstick.family("void bwd_dkdv_wgmma<128>") == "flash_bwd"
    assert yardstick.family("void agg_kernel<float, 4, false>") == \
        "aggregation"
    assert yardstick.family(
        "void at::native::vectorized_elementwise_kernel<4, ...>") == \
        "elementwise"
