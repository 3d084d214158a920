"""granite-4.0-h-small's configuration, cell and readers on the CPU: the
program's model is the published configuration's, cut only where the
file says; its model FLOPs are the formula of the published shapes; the
scoring loop's check comes out correct at the tiny sizes and not correct
under planted faults and the fp8 control; the counter reader, the SSD
roofline of a hybrid, the expert products' bound and the experts' load
imbalance."""
from __future__ import annotations

import json
import types

import pytest
import torch

from perfbench import harness, program_counters
from perfbench._testing import REPO, run, tiny_root
from perfbench.harness import load_file

CELL = "granite-4.0-h-small.score"
METRICS = REPO / "perfbench" / "metrics"


def config():
    return json.loads((REPO / "perfbench" / "configs"
                       / "granite-4.0-h-small.json").read_text())


def test_model_is_the_published_configuration():
    c = config()
    m = c["model"]
    assert (m["family"], m["n_layers"], m["d_model"]) == (
        "hybrid_moe", c["num_hidden_layers"], c["hidden_size"])
    assert m["layer_types"] == c["layer_types"]
    assert (m["n_heads"], m["n_kv_heads"]) == (
        c["num_attention_heads"], c["num_key_value_heads"])
    assert (m["d_ff"], m["shared_d_ff"]) == (
        c["intermediate_size"], c["shared_intermediate_size"])
    assert (m["n_experts"], m["top_k"]) == (
        c["num_local_experts"], c["num_experts_per_tok"])
    assert (m["ssm_state"], m["ssm_headdim"], m["ssm_expand"],
            m["ssm_chunk"], m["ssm_conv_width"], m["ssm_conv_bias"]) == (
        c["mamba_d_state"], c["mamba_d_head"], c["mamba_expand"],
        c["mamba_chunk_size"], c["mamba_d_conv"], c["mamba_conv_bias"])
    assert m["ssm_expand"] * m["d_model"] // m["ssm_headdim"] == \
        c["mamba_n_heads"] and c["mamba_n_groups"] == 1
    assert (m["embedding_multiplier"], m["residual_multiplier"],
            m["logits_scaling"], m["attention_multiplier"]) == (
        c["embedding_multiplier"], c["residual_multiplier"],
        c["logits_scaling"], c["attention_multiplier"])
    assert m["nope"] == (c["position_embedding_type"] == "nope")
    assert (m["vocab_size"], m["tie_embeddings"]) == (
        c["vocab_size"], c["tie_word_embeddings"])
    assert m["vocab_size"] % 128 == 0          # no padded rows
    # the cut: half the experts held, listed; nothing else changed
    assert c["reduced"] == ["experts_held"] and m["experts_held"] == \
        c["experts_held"] == c["num_local_experts"] // 2
    bench = harness.load_benchmark(REPO)
    entry = [x for x in bench["configs"] if x["name"] == c["name"]][0]
    assert entry["reduced"] == c["reduced"] and entry["source"] == \
        c["source"] and c["departures"] == []


def test_flops_are_the_published_shapes():
    """The matmul parameters a token runs (five held slots expected of its
    ten, 36 of 72 experts held), the chunked scan and the convolution of
    each Mamba2 layer, and q k and p v over each attention layer's keys."""
    c = config()
    d, V = c["hidden_size"], c["vocab_size"]
    kinds = c["layer_types"]
    n_m, n_a = kinds.count("mamba"), kinds.count("attention")
    di, n, p = 2 * d, c["mamba_d_state"], c["mamba_d_head"]
    nh, q, W = di // p, c["mamba_chunk_size"], c["mamba_d_conv"]
    hd = d // c["num_attention_heads"]
    mamba = d * (2 * di + 2 * n + nh) + di * d
    attn = 2 * d * d + 2 * d * c["num_key_value_heads"] * hd
    slots = c["num_experts_per_tok"] * c["experts_held"] \
        / c["num_local_experts"]
    ffn = d * c["num_local_experts"] + 3 * d * c[
        "shared_intermediate_size"] + slots * 3 * d * c["intermediate_size"]
    params = n_m * mamba + n_a * attn + len(kinds) * ffn + V * d
    scan = n * (q + 1) + nh * (p * (q + 1) + 4 * n * p)
    conv = 2 * W * (di + 2 * n)
    assert c["flops_per_token"] == {"score": {
        "per_token": 2 * params + n_m * (scan + conv),
        "per_key": 4 * n_a * c["num_attention_heads"] * hd}}
    assert round(c["flops_per_token"]["score"]["per_token"] / 1e9, 2) == 14.06


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _experts_left_out(mp):
    from repro_torch.models import moe
    mp.setattr(moe, "dropless_moe",
               lambda p, cfg, x, first=0: torch.zeros(x.shape))


def _shared_left_out(mp):
    from repro_torch.models import layers as L
    from repro_torch.models import hybrid_moe
    orig = L.apply_mlp
    mp.setattr(hybrid_moe.L, "apply_mlp",
               lambda p, cfg, x, d_ff=None: orig(p, cfg, x, d_ff) * 0)


def _attention_at_the_default_scale(mp):
    from repro_torch.kernels import ops
    orig = ops.flash_attention
    mp.setattr(ops, "flash_attention", lambda *a, scale=None, **kw: orig(
        *a, **kw))


def _conv_bias_left_out(mp):
    from repro_torch.models import mamba2
    orig = mamba2.causal_conv
    mp.setattr(mamba2, "causal_conv", lambda x, w, state=None, bias=None:
               orig(x, w, state))


@pytest.mark.parametrize("fault", [None, _experts_left_out,
                                   _shared_left_out,
                                   _attention_at_the_default_scale,
                                   _conv_bias_left_out])
def test_check_parts_faults(root, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    r = run(root, CELL)
    assert r["correct"] == (fault is None), r["checks"]


def test_fp8_control_separates_on_both_numbers(root):
    """The reference in fp8 matmuls, in the program's place, reads over
    three times the program on both numbers, and is not correct."""
    ctl = run(root, CELL, variant="fp8")
    prog = run(root, CELL)["checks"]
    assert not ctl["correct"], ctl["checks"]
    for k, c in ctl["checks"].items():
        assert c["value"] > 3 * prog[k]["value"], (k, c, prog[k])


def test_counter_reader_takes_the_last_units(monkeypatch):
    from repro_torch.core import spans
    # three scoring units, the first the profiler's first cycle: a span,
    # a count of 10, 20, 30 in it, the unit's marker
    recs, counts = [], []
    for u in range(3):
        recs.append(spans.Span(3 * u, None, "moe.experts", 0, 0, 1.0))
        counts.append(spans.Count(3 * u + 1, "moe.pairs_held", 10 * (u + 1)))
        recs.append(spans.Span(3 * u + 2, None, "loss.cross_entropy", 0, 0,
                               1.0))
    monkeypatch.setattr(spans, "finished", lambda: recs)
    monkeypatch.setattr(spans, "counted", lambda: counts)
    run_ = types.SimpleNamespace(trace={"steps": 2})
    assert program_counters.per_unit(run_, "moe.pairs_held", "score") == \
        (20 + 30) / 2
    assert program_counters.per_unit(run_, "moe.pairs_dropped",
                                     "score") is None
    assert program_counters.per_unit(types.SimpleNamespace(trace=None),
                                     "moe.pairs_held", "score") is None
    run_ = types.SimpleNamespace(trace={"steps": 3})    # too few units
    assert program_counters.per_unit(run_, "moe.pairs_held",
                                     "score") is None


def test_hybrid_ssd_roofline_counts_its_mamba_layers():
    hybrid = load_file(METRICS / "ssd_scan_roofline.hybrid.py", "ssdh")
    score = load_file(METRICS / "ssd_scan_roofline.score.py", "ssds")
    c = config()
    t = {"batch": 8, "seq": 4096}
    one = score.bound_s(8, 4096, 128, 64, 128, 256)
    run_ = types.SimpleNamespace(
        model=c["model"], traffic=t,
        trace={"steps": 2, "kernels": {"ssd_scan_wgmma_kernel<...>":
                                       [72 * one * 2, 72]}})
    assert hybrid.read(run_) == pytest.approx(50.0)


def test_expert_products_bound():
    mod = load_file(METRICS / "expert_gemm_roofline.score.py", "eg")
    # 8 x 4096 tokens, five held slots each, 40 layers: 123.7 TFLOP at the
    # bf16 peak, the bytes far below
    pairs = 40 * 8 * 4096 * 5
    assert round(mod.bound_s(pairs, 40, 36, 4096, 768) * 1e3, 1) == 125.1


def test_expert_imbalance_reads_both_counters(monkeypatch):
    mod = load_file(METRICS / "expert_imbalance.score.py", "ei")
    per_unit = {"moe.pairs_busiest": 40 * 6000.0,
                "moe.pairs_held": 40 * 36 * 4500.0}
    monkeypatch.setattr(program_counters, "per_unit",
                        lambda run, name, kind: per_unit.get(name))
    run_ = types.SimpleNamespace(model=config()["model"])
    assert mod.read(run_) == pytest.approx(6000 / 4500)
    del per_unit["moe.pairs_busiest"]              # a program without it
    assert mod.read(run_) is None
