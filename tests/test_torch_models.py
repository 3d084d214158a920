"""The port's dense family (``repro_torch.models``) against the reference on
reduced configs: the same numpy batch, the reference's weights carried
across with ``params_from_numpy``. Tolerances are those of
``tests/test_kernel_integration.py`` (loss rtol 1e-5, grads rtol 5e-4 /
atol 1e-5)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import ARCHS, reduced, reduced_batch  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402

DENSE = ["olmo-1b", "qwen2.5-3b", "phi4-mini-3.8b", "mistral-large-123b"]
_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _carry(jparams):
    return registry.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")


def _both(arch, seed=0, **kw):
    jcfg = j_reduced(J_ARCHS[arch]).replace(**kw)
    cfg = reduced(ARCHS[arch]).replace(**kw)
    jparams = jreg.init(jax.random.key(seed), jcfg)
    return jcfg, cfg, jparams, _carry(jparams)


@functools.lru_cache(maxsize=None)
def _ref_loss(arch):
    jcfg, _, jparams, _ = _both(arch, head_dim=32)
    batch = reduced_batch(jcfg, 2, 64)
    return float(jreg.loss_fn(jparams, jcfg.replace(use_flash_kernel=True),
                              batch))


@functools.lru_cache(maxsize=None)
def _ref_grads(arch):
    jcfg, _, jparams, _ = _both(arch, seed=1)
    batch = reduced_batch(jcfg, 2, 32)
    jg = jax.grad(lambda p: jreg.loss_fn(
        p, jcfg.replace(use_flash_kernel=True), batch))(jparams)
    return [np.asarray(x) for x in jax.tree.leaves(jg)]


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-3b"])
@pytest.mark.parametrize("flash", [False, True])
def test_loss_matches_reference(arch, flash):
    _, cfg, _, params = _both(arch, head_dim=32)
    batch = reduced_batch(cfg, 2, 64)
    want = _ref_loss(arch)
    got = float(registry.loss_fn(params, cfg.replace(use_flash_kernel=flash),
                                 T.from_numpy(batch, "cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-3b"])
@pytest.mark.parametrize("flash", [False, True])
def test_grads_match_reference(arch, flash):
    _, cfg, _, params = _both(arch, seed=1)
    batch = reduced_batch(cfg, 2, 32)
    c = cfg.replace(use_flash_kernel=flash)
    g = T.grad(lambda p, b: registry.loss_fn(p, c, b))(
        params, T.from_numpy(batch, "cpu"))
    jl, tl = _ref_grads(arch), T.leaves(g)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), a, rtol=5e-4, atol=1e-5)


def test_bf16_forward_runs_with_flash():
    cfg = reduced(ARCHS["olmo-1b"]).replace(dtype=torch.bfloat16,
                                            use_flash_kernel=True)
    params = registry.init(0, cfg, "cpu")
    batch = T.from_numpy(reduced_batch(cfg, 2, 32), "cpu")
    loss = registry.loss_fn(params, cfg, batch)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-3b"])
def test_decode_after_prefill_matches_full_forward(arch):
    """Teacher-forced decode logits equal the full forward position-wise,
    and the prefill logits equal the reference's."""
    jcfg, cfg, jparams, params = _both(arch)
    S = 32
    batch = reduced_batch(cfg, 2, S)
    toks = T.from_numpy(batch, "cpu")["tokens"]
    full, _ = registry.prefill(params, cfg, {"tokens": toks}, max_seq=S)
    jfull, _ = jreg.prefill(jparams, jcfg, batch, max_seq=S)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=1e-4,
                               atol=1e-4)
    half = S // 2
    _, cache = registry.prefill(params, cfg, {"tokens": toks[:, :half]},
                                max_seq=S)
    for t in range(half, half + 3):
        logits, cache = registry.decode_step(params, cfg, cache, t,
                                             toks[:, t:t + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-2, atol=2e-3)


def test_blockwise_matches_naive_attention():
    from repro_torch.kernels.ref import ref_attention
    rng = np.random.RandomState(0)
    q, k, v = [torch.from_numpy(rng.randn(2, 70, 3, 32).astype(np.float32))
               for _ in range(3)]
    for window in (0, 20):
        got = L.blockwise_attention(q, k, v, causal=True,
                                    sliding_window=window, q_block=16)
        want = ref_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True,
                             window=window).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_cross_entropy_masks_padding_and_ignored_labels():
    cfg = reduced(ARCHS["olmo-1b"])
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(
        rng.randn(2, 5, cfg.vocab_padded).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 5)))
    labels[0, 2] = -1
    big = logits.clone()
    big[..., cfg.vocab_size:] = 1e4          # padding columns never count
    a = L.cross_entropy(logits, labels, cfg)
    b = L.cross_entropy(big, labels, cfg)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    full = torch.nn.functional.cross_entropy(
        logits[..., :cfg.vocab_size].reshape(-1, cfg.vocab_size),
        labels.reshape(-1).long(), ignore_index=-1)
    np.testing.assert_allclose(float(a), float(full), rtol=1e-5)


def test_rope_relative_invariance():
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(1, 1, 1, 32).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 1, 1, 32).astype(np.float32))

    def dot(pq, pk):
        a = L.apply_rope(q, torch.tensor([pq]), 10_000.0)
        b = L.apply_rope(k, torch.tensor([pk]), 10_000.0)
        return float((a * b).sum())
    np.testing.assert_allclose(dot(5, 3), dot(12, 10), rtol=1e-5)


def test_norms_and_rope_match_reference():
    from repro.models import layers as JL
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 128).astype(np.float32)
    for norm in ("rmsnorm", "layernorm", "nonparametric_ln"):
        cfg = reduced(ARCHS["olmo-1b"]).replace(norm=norm)
        jcfg = j_reduced(J_ARCHS["olmo-1b"]).replace(norm=norm)
        p = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in L.init_norm(cfg, "cpu").items()}
        got = L.apply_norm(T.from_numpy(p, "cpu"), cfg, torch.from_numpy(x))
        want = JL.apply_norm(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    xr = rng.randn(2, 6, 4, 32).astype(np.float32)
    pos = np.arange(6)
    got = L.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 1e6)
    want = JL.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gelu_mlp_matches_reference():
    from repro.models import layers as JL
    cfg = reduced(ARCHS["olmo-1b"]).replace(mlp="gelu")
    jcfg = j_reduced(J_ARCHS["olmo-1b"]).replace(mlp="gelu")
    p = jax.tree.map(np.asarray, JL.init_mlp(jax.random.key(0), jcfg))
    x = np.random.RandomState(4).randn(2, 5, 128).astype(np.float32)
    got = L.apply_mlp(T.from_numpy(p, "cpu"), cfg, torch.from_numpy(x))
    want = JL.apply_mlp(p, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# configs, param counts, the weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_config_fields_match_reference(arch):
    for mine, theirs in ((ARCHS[arch], J_ARCHS[arch]),
                         (reduced(ARCHS[arch]), j_reduced(J_ARCHS[arch]))):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert jnp.dtype(_DT[a.pop("dtype")]) == jnp.dtype(b.pop("dtype"))
        assert a == b
        assert mine.vocab_padded == theirs.vocab_padded
        if mine.n_heads:
            assert mine.resolved_head_dim == theirs.resolved_head_dim
        assert mine.d_inner == theirs.d_inner


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_reference(arch):
    assert registry.param_count(ARCHS[arch]) == jreg.param_count(J_ARCHS[arch])
    assert registry.param_bytes(ARCHS[arch]) == jreg.param_bytes(J_ARCHS[arch])


def test_olmo_1b_full_width():
    cfg = ARCHS["olmo-1b"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size, cfg.dtype) == (16, 2048, 16, 8192, 50_304,
                                           torch.bfloat16)
    assert registry.param_count(cfg) == 1_279_787_008


def test_other_families_name_their_roadmap_item():
    """Every family in ARCHS has its module in the port (vlm and audio
    were the last, ROADMAP A14), and the two cross-attention families
    count the reference's parameters, llama-3.2-vision-90b also at the
    depth of 20 the card runs."""
    from repro_torch.models import encdec, hybrid, moe, vlm
    for cfg in ARCHS.values():
        assert registry.family_module(cfg) is not None
    assert registry.family_module(ARCHS["zamba2-7b"]) is hybrid
    assert registry.family_module(ARCHS["arctic-480b"]) is moe
    assert registry.family_module(ARCHS["llama-3.2-vision-90b"]) is vlm
    assert registry.family_module(ARCHS["seamless-m4t-medium"]) is encdec
    assert registry.param_count(ARCHS["seamless-m4t-medium"]) == 878_309_376
    vision = ARCHS["llama-3.2-vision-90b"]
    assert registry.param_count(vision) == 87_677_280_296
    assert registry.param_count(vision.replace(n_layers=20)) == \
        19_224_928_264


def test_params_bridge_roundtrip_keeps_keys_shapes_and_bits():
    cfg = ARCHS["olmo-1b"].replace(n_layers=2, d_model=64, n_heads=4,
                                   n_kv_heads=4, d_ff=128, vocab_size=300)
    jcfg = J_ARCHS["olmo-1b"].replace(n_layers=2, d_model=64, n_heads=4,
                                      n_kv_heads=4, d_ff=128, vocab_size=300)
    jparams = jreg.init(jax.random.key(0), jcfg)        # bf16 leaves
    params = _carry(jparams)
    mine = registry.init(0, cfg, "cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jparams)) == \
        jax.tree.structure(T.tree_map(lambda x: 0, mine))
    for a, b, c in zip(jax.tree.leaves(jparams), T.leaves(params),
                       T.leaves(mine)):
        assert b.dtype == torch.bfloat16 and b.shape == c.shape == a.shape
    back = registry.params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(jparams), T.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def _remat_parity(cfg, params, batch, policy):
    """Loss and grads with remat (``policy``) on are those with it off."""
    vg = lambda c: T.value_and_grad(  # noqa: E731
        lambda p, b: registry.loss_fn(p, c, b))(params, batch)
    l0, g0 = vg(cfg)
    l1, g1 = vg(cfg.replace(remat=True, remat_policy=policy))
    assert float(l1) == float(l0)
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("flash", [False, True])
def test_remat_matches_no_remat(policy, flash):
    _, cfg, _, params = _both("olmo-1b", seed=1)
    _remat_parity(cfg.replace(use_flash_kernel=flash), params,
                  T.from_numpy(reduced_batch(cfg, 2, 32), "cpu"), policy)


def test_remat_dots_keeps_the_projections():
    """The backward of remat "full" runs the forward's matmuls again;
    "dots" keeps their outputs (jax's dots_with_no_batch_dims_saveable),
    so its backward runs no more of them than remat off."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    _, cfg, _, params = _both("olmo-1b", seed=1)
    batch = T.from_numpy(reduced_batch(cfg, 2, 32), "cpu")
    counts = {}
    for name, c in (("off", cfg), ("full", cfg.replace(remat=True)),
                    ("dots", cfg.replace(remat=True, remat_policy="dots"))):
        with torch.enable_grad():
            p = T.tree_map(lambda x: x.detach().requires_grad_(True), params)
            loss = registry.loss_fn(p, c, batch)
            CountMM.n = 0
            with CountMM():
                torch.autograd.grad(loss, T.leaves(p))
            counts[name] = CountMM.n
    assert counts["dots"] == counts["off"] < counts["full"], counts
