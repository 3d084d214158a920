"""The ``hybrid_moe`` family (granite-4.0-h) against the plain float32
reference ``perfbench/reference/hybrid_moe.py`` on seeded random weights at
a small size on the CPU (d 256, six layers m m a m m a, 8 experts of
which 4 held, top 3): the loss and the sampled logits; the share rule
(the routed parts of two shares add up to the uncut layer, the shared MLP
once); no pair dropped under a router that sends every token to one
expert, and a dropped-pairs counter that sees products losing a row;
the expert products off the CPU, grouped on bf16 and refused on any other
dtype, and ``chip_smoke.py``'s hold of them against plain; the flash ``scale`` argument against plain softmax attention,
forward and backward; and what the family refuses. The family has no
twin in the JAX package, so the reference is the plain PyTorch one."""
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from perfbench.reference import common as C  # noqa: E402
from perfbench.reference import hybrid_moe as R  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2, moe, registry  # noqa: E402
from repro_torch.models.base import ModelConfig  # noqa: E402

KINDS = ["mamba", "mamba", "attention", "mamba", "mamba", "attention"]
M = dict(family="hybrid_moe", n_layers=6, d_model=256, n_heads=4,
         n_kv_heads=2, d_ff=64, vocab_size=2048, ssm_state=16,
         ssm_expand=2, ssm_headdim=32, ssm_chunk=16, ssm_conv_width=4,
         ssm_conv_bias=True, tie_embeddings=True, norm="rmsnorm",
         n_experts=8, experts_held=4, top_k=3, shared_d_ff=128,
         layer_types=KINDS, embedding_multiplier=12.0,
         residual_multiplier=0.22, logits_scaling=16.0,
         attention_multiplier=1 / 64, nope=True)
GRANITE = dict(M, n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
               d_ff=768, vocab_size=100352, ssm_state=128, ssm_headdim=64,
               ssm_chunk=256, n_experts=72, experts_held=36, top_k=10,
               shared_d_ff=1536, attention_multiplier=1 / 128,
               layer_types=(["mamba"] * 5 + ["attention"]
                            + (["mamba"] * 9 + ["attention"]) * 3
                            + ["mamba"] * 4))


def cfg_of(m, **kw):
    return ModelConfig(arch_id="granite-test", **dict(m, **kw))


def weights(m, seed=3):
    return C.make_weights(R.spec(m), seed, torch.device("cpu"),
                          torch.float32)


def tokens(vocab, rows, seq, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (rows, seq), generator=g)


def test_reference_layout_is_the_programs_and_the_cut():
    """The reference's weights are the program's leaves; held here, 18.62 B
    parameters of the published 32.2 B."""
    for m in (M, GRANITE):
        cfg = cfg_of(m)
        want = {p: tuple(x.shape) for p, x in T.leaves_with_path(
            registry.init(0, cfg, device="meta"))}
        assert {p: s for p, s, _ in R.spec(m)} == want
    assert registry.param_count(cfg_of(GRANITE)) == 18_617_793_024
    assert registry.param_count(cfg_of(GRANITE, experts_held=72)) == \
        32_207_337_984


def test_loss_and_sampled_logits_match_reference():
    """float32 on both sides: the program's chunked SSD, blockwise
    attention and atomically-ordered scatter-add sum in other orders than
    the reference's quadratic SSD, plain softmax and per-expert adds, so
    results agree to float32 round-off over six layers (1e-5 of the
    logits' scale), not bit for bit."""
    cfg = cfg_of(M, dtype=torch.float32)
    w = weights(M)
    x = tokens(M["vocab_size"], 3, 40)
    pos = torch.tensor([[0, 7, 38], [3, 20, 21], [39 - 1, 1, 30]])
    with torch.no_grad():
        loss = registry.loss_fn(w, cfg, {"tokens": x, "labels": x})
        loss2, got = registry.loss_fn(w, cfg, {"tokens": x, "labels": x,
                                               "logit_positions": pos})
    assert torch.equal(loss, loss2)
    s, n = R.loss_sum(w, M, x, C.matmul("f32"))
    assert s / n == pytest.approx(float(loss), rel=1e-6)
    rows, logits = R.sampled(w, M, x, pos, C.matmul("f32"))
    torch.testing.assert_close(got["row_loss"].double(), rows, rtol=1e-6,
                               atol=0)
    scale = float(logits.pow(2).mean().sqrt())
    torch.testing.assert_close(got["logits"], logits, rtol=0,
                               atol=1e-5 * scale)
    # the rows' mean is the loss
    assert float(got["row_loss"].mean()) == pytest.approx(float(loss),
                                                          rel=1e-6)


def _ffn_layer(w, i=0):
    return {k: v for k, v in R.layer(w["ffn"], i).items()}


def test_shares_add_up_to_the_uncut_layer():
    """Two chips of a 2-way expert-parallel deployment, experts 0-3 and
    4-7: their routed parts, plus the shared MLP counted once, are the
    uncut reference's FFN; every share routes over all 8 experts."""
    uncut = dict(M, experts_held=8)
    cfg = cfg_of(uncut, dtype=torch.float32)
    p = _ffn_layer(weights(uncut))
    h = torch.randn(2, 24, 256, generator=torch.Generator().manual_seed(4))
    x = L.apply_norm(p["ln"], cfg, h)
    parts = []
    for first in (0, 4):
        share = dict(p, experts={k: v[first:first + 4]
                                 for k, v in p["experts"].items()})
        parts.append(moe.dropless_moe(share, cfg, x, first=first))
    shared = L.apply_mlp(p["shared"], cfg, x, d_ff=M["shared_d_ff"])
    want = R.ffn(p, uncut, h, C.matmul("f32"))
    # float32 round-off of sums of a few terms of order 1
    torch.testing.assert_close(parts[0] + parts[1] + shared, want,
                               rtol=1e-5, atol=1e-5)
    # one share alone is the reference's same share
    ref0 = R.routed(dict(p, experts={k: v[:4] for k, v in
                                     p["experts"].items()}), uncut,
                    x.reshape(-1, 256), C.matmul("f32"))
    torch.testing.assert_close(parts[0].reshape(-1, 256), ref0, rtol=1e-5,
                               atol=1e-5)


def test_dropless_under_a_router_that_sends_every_token_to_one_expert():
    """Every token's top 3 holds expert 2: its pairs are all computed
    (GShard's capacity of 1.25 k t / E would keep under half of them), the
    counters say so, and the result is the reference's."""
    cfg = cfg_of(M, dtype=torch.float32)
    p = _ffn_layer(weights(M))
    x = torch.randn(1, 64, 256, generator=torch.Generator().manual_seed(5))
    x[..., 0] = 4.0
    p["router"][0, 2] = 50.0
    spans.clear()
    with spans.recording():
        out = moe.dropless_moe(p, cfg, x)
    counts = {c.name: c.value for c in spans.counted()}
    spans.clear()
    t = x.shape[1]
    top = torch.topk(x[0] @ p["router"], 3, dim=-1).indices
    assert bool((top == 2).any(-1).all())
    assert counts["moe.pairs_busiest"] == t > 1.25 * 3 * t / 8
    assert counts["moe.pairs_held"] == int((top < 4).sum())
    assert counts["moe.pairs_dropped"] == 0
    want = R.routed(p, M, x[0], C.matmul("f32"))
    torch.testing.assert_close(out[0], want, rtol=1e-5, atol=1e-5)


def test_dropped_pairs_counter_sees_rows_the_products_lose(monkeypatch):
    """The counter compares the pairs the router sent to held experts with
    the rows the products gave back: products that lose a row read 1."""
    cfg = cfg_of(M, dtype=torch.float32)
    p = _ffn_layer(weights(M))
    x = torch.randn(1, 64, 256, generator=torch.Generator().manual_seed(6))
    whole = moe.held_products
    monkeypatch.setattr(moe, "held_products",
                        lambda *a: whole(*a)[:-1])
    spans.clear()
    with spans.recording(), pytest.raises(RuntimeError):
        moe.dropless_moe(p, cfg, x)      # the combine's rows fall short
    counts = {c.name: c.value for c in spans.counted()}
    spans.clear()
    assert counts["moe.pairs_dropped"] == 1 and counts["moe.pairs_held"] > 1


def _grouped_called(*args, **kwargs):
    raise LookupError("grouped products called")


@pytest.mark.parametrize("dtype,rows,raises", [
    (torch.float32, [3, 0, 2], TypeError),
    (torch.float16, [3, 0, 2], TypeError),
    (torch.bfloat16, [3, 0, 2], LookupError),
    (torch.bfloat16, [0, 0, 0], None),
])
def test_held_products_off_the_cpu_never_take_the_plain_path(
        monkeypatch, dtype, rows, raises):
    """Off the CPU (the meta device stands in for CUDA) the expert products
    are the grouped ones on bf16, a refusal on any other dtype, and no
    call at all where no row exists: never the per-expert loop."""
    monkeypatch.setattr(torch, "_grouped_mm", _grouped_called)
    monkeypatch.setattr(moe, "plain_held_products", _grouped_called)
    held, d, f = len(rows), 64, 16
    ex = {"w1": torch.empty(held, d, 2 * f, dtype=dtype, device="meta"),
          "w2": torch.empty(held, f, d, dtype=dtype, device="meta")}
    xs = torch.empty(sum(rows), d, dtype=dtype, device="meta")
    counts = torch.tensor(rows, device="meta")
    if raises is None:
        out = moe.held_products(ex, xs, counts, rows)
        assert out.shape == (0, d) and out.dtype == dtype
    else:
        with pytest.raises(raises):
            moe.held_products(ex, xs, counts, rows)


def test_counters_record_only_while_spans_do():
    spans.clear()
    spans.count("off", 3)
    assert spans.counted() == [] and not spans.on()
    with spans.recording():
        with spans.span("a"):
            spans.count("n", 2)
        spans.count("n", 5)
    got = spans.counted()
    a = [s for s in spans.finished() if s.name == "a"][0]
    assert [(c.name, c.value) for c in got] == [("n", 2), ("n", 5)]
    assert a.id < got[0].id < got[1].id
    spans.clear()
    assert spans.counted() == []


def _plain_attention(q, k, v, scale):
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    n = q.shape[2]
    mask = torch.ones(n, n, dtype=torch.bool).tril()
    return torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v.float()


@pytest.mark.parametrize("scale", [None, 1 / 128, 0.3])
def test_flash_scale_against_plain_softmax(scale):
    """The flash wrapper's forward and backward (plain versions on the CPU)
    at a model's own softmax scale, and at the default d^-0.5."""
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 3, 80, 64, generator=g, requires_grad=True)
               for _ in range(3))
    sc = 64 ** -0.5 if scale is None else scale
    out = ops.flash_attention(q, k, v, causal=True, block_q=32, block_k=32,
                              scale=scale)
    want = _plain_attention(q, k, v, sc)
    # float32 round-off of 80-term sums
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    dout = torch.randn(out.shape, generator=g)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    wants = torch.autograd.grad(want, (q, k, v), dout)
    for a, b in zip(grads, wants):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if scale is None:          # the default is the d^-0.5 it always was
        assert torch.equal(fa.plain_flash_attention(q, k, v),
                           fa.plain_flash_attention(q, k, v, scale=sc))


@pytest.mark.parametrize("fault", [None, "experts_rolled"])
def test_smoke_holds_the_expert_products_against_plain(fault, monkeypatch):
    """chip_smoke.py's hold passes each flash, SSD and expert products call
    of the family's forward, and fails products that use another expert's
    weights."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    cfg = cfg_of(M, dtype=torch.float32, use_flash_kernel=True,
                 use_ssd_kernel=True)
    params = registry.init(0, cfg, device="cpu")
    if fault:
        whole = moe.held_products
        monkeypatch.setattr(moe, "held_products", lambda ex, *a: whole(
            {k: v.roll(1, 0) for k, v in ex.items()}, *a))
    before = moe.held_products
    calls = []
    batch = {"tokens": tokens(M["vocab_size"], 2, 32)}
    batch["labels"] = batch["tokens"]
    with cs.held_against_plain(calls), torch.no_grad():
        if fault:
            with pytest.raises(RuntimeError, match="inside the model"):
                registry.loss_fn(params, cfg, batch)
        else:
            registry.loss_fn(params, cfg, batch)
    if not fault:
        names = [n for n, _ in calls]
        assert [names.count(k) for k in ("flash_attention", "ssd_scan",
                                         "expert_products")] == [2, 4, 6]
        assert all(r == 0.0 for _, r in calls)   # the CPU runs plain
    assert moe.held_products is before             # restored


def test_mixer_is_the_block_without_its_residual():
    cfg = ModelConfig(family="ssm", n_layers=1, d_model=64, ssm_state=16,
                      ssm_headdim=16, ssm_chunk=8, dtype=torch.float32)
    gen = torch.Generator().manual_seed(8)
    bp = mamba2.init_mamba_block(
        lambda s: torch.randn(s, generator=gen), cfg, "cpu")
    h = torch.randn(2, 20, 64, generator=gen)
    out, c1 = mamba2.mamba_mixer(bp, cfg, h)
    full, c2 = mamba2.apply_mamba_block(bp, cfg, h)
    assert torch.equal(full, h + out)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)
    assert "conv_x_bias" not in bp
    bias = torch.randn(bp["conv_x"].shape[1], generator=gen)
    x = torch.randn(2, 20, bp["conv_x"].shape[1], generator=gen)
    with_bias, _ = mamba2.causal_conv(x, bp["conv_x"], bias=bias)
    raw = sum(bp["conv_x"][i] * F.pad(x, (0, 0, 3, 0))[:, i:i + 20]
              for i in range(4))
    torch.testing.assert_close(with_bias, F.silu(raw + bias))


def test_what_the_family_refuses():
    cfg = cfg_of(M, dtype=torch.float32)
    assert "hybrid_moe" not in registry.MODEL_AXIS_FAMILIES
    registry.check_model_axis(cfg, 1)
    with pytest.raises(NotImplementedError, match="no model axis"):
        registry.check_model_axis(cfg, 2)
    w = weights(M)
    x = tokens(M["vocab_size"], 1, 8)
    with pytest.raises(NotImplementedError, match="no cache"):
        registry.prefill(w, cfg, {"tokens": x})
    with pytest.raises(ValueError, match="layer_types"):
        registry.init(0, cfg_of(M, layer_types=KINDS[:5]), device="meta")
