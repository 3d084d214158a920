"""The port's VLM decoder (``repro_torch.models.vlm``, llama-3.2-vision-90b)
against the reference on the reduced config in f32 (2 groups of one self
layer and one cross layer, 4 query heads on 1 KV head): the same numpy
inputs, the reference's weights carried across with ``params_from_numpy``.
The cross layers' tanh gates are zero at init, which would hide any fault
in the cross-attention and cross MLP, so both packages' gates are set to
0.5 before they are compared. The reference's flash kernel runs in Pallas
interpret mode, as its own tests run it. Tolerances: loss rtol 1e-5 and
grads rtol 5e-4 / atol 1e-5 (``tests/test_kernel_integration.py:11-31``);
decode after prefill against prefill rtol 2e-2 / atol 2e-3
(``tests/test_arch_smoke.py:57-74``); logits and caches against the
reference rtol 1e-4 / atol 1e-4, as the dense family's test."""
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
from repro_torch.models import registry, vlm  # noqa: E402

ARCH = "llama-3.2-vision-90b"
S = 48        # tokens; the reduced config has 16 image tokens
GATE = 0.5


@functools.lru_cache(maxsize=None)
def _models(seed=0):
    jcfg = j_reduced(J_ARCHS[ARCH])
    cfg = reduced(ARCHS[ARCH])
    jparams = jreg.init(jax.random.key(seed), jcfg)
    for g in ("gate_attn", "gate_mlp"):
        jparams["cross"][g] = jnp.full_like(jparams["cross"][g], GATE)
    params = registry.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, cfg, jparams, params


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_tree(got, want, **kw):
    assert jax.tree.structure(T.tree_map(lambda x: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, want))
    for a, b in zip(T.leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape
        _close(a, b, **kw)


def test_params_cross_key_for_key_and_gates_start_closed():
    jcfg, cfg, jparams, params = _models()
    ng, per_self = vlm.group_shape(cfg)
    assert (ng, per_self) == (2, 1)
    mine = registry.init(0, cfg, "cpu")
    assert sorted(mine) == ["blocks", "cross", "embed", "final_norm",
                            "vision_proj"]
    assert jax.tree.structure(jax.tree.map(np.asarray, jparams)) == \
        jax.tree.structure(T.tree_map(lambda x: 0, mine))
    for a, b, c in zip(jax.tree.leaves(jparams), T.leaves(params),
                       T.leaves(mine)):
        assert a.shape == tuple(b.shape) == tuple(c.shape)
        assert b.dtype == c.dtype == torch.float32
    assert mine["blocks"]["attn"]["wq"].shape[0] == ng * per_self
    assert mine["cross"]["attn"]["wk"].shape[0] == ng
    for g in ("gate_attn", "gate_mlp"):
        assert tuple(mine["cross"][g].shape) == (ng,)
        assert not mine["cross"][g].any()
        assert bool((params["cross"][g] == GATE).all())


def test_group_shape_asserts_whole_groups():
    with pytest.raises(AssertionError, match="cross groups"):
        vlm.group_shape(reduced(ARCHS[ARCH]).replace(n_layers=5))


@functools.lru_cache(maxsize=None)
def _ref_loss(flash: bool):
    jcfg, _, jparams, _ = _models()
    return float(jreg.loss_fn(jparams, jcfg.replace(use_flash_kernel=flash),
                              reduced_batch(jcfg, 2, S)))


@pytest.mark.parametrize("flash", [False, True])
def test_loss_matches_reference(flash):
    _, cfg, _, params = _models()
    batch = T.from_numpy(reduced_batch(cfg, 2, S), "cpu")
    got = float(registry.loss_fn(params, cfg.replace(use_flash_kernel=flash),
                                 batch))
    np.testing.assert_allclose(got, _ref_loss(flash), rtol=1e-5)
    # tests/test_kernel_integration.py's gate check: kernel on == off
    np.testing.assert_allclose(got, _ref_loss(not flash), rtol=1e-5)


def test_open_gates_change_the_loss():
    """The cross layers are live in these tests: closing the gates moves
    the loss."""
    _, cfg, _, params = _models()
    batch = T.from_numpy(reduced_batch(cfg, 2, S), "cpu")
    closed = dict(params, cross=dict(
        params["cross"], gate_attn=torch.zeros(2), gate_mlp=torch.zeros(2)))
    a = float(registry.loss_fn(params, cfg, batch))
    b = float(registry.loss_fn(closed, cfg, batch))
    assert abs(a - b) > 1e-3 * abs(a)


@pytest.mark.parametrize("flash", [False, True])
def test_grads_match_reference(flash):
    jcfg, cfg, jparams, params = _models(seed=1)
    batch = reduced_batch(cfg, 2, 32)
    jg = jax.grad(lambda p: jreg.loss_fn(p, jcfg, batch))(jparams)
    c = cfg.replace(use_flash_kernel=flash)
    g = T.grad(lambda p, b: registry.loss_fn(p, c, b))(
        params, T.from_numpy(batch, "cpu"))
    jl, tl = jax.tree.leaves(jg), T.leaves(g)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b, a, rtol=5e-4, atol=1e-5)


def test_prefill_and_three_decode_steps_match_reference(monkeypatch):
    jcfg, cfg, jparams, params = _models()
    batch = reduced_batch(cfg, 2, S)
    logits, cache = registry.prefill(params, cfg, T.from_numpy(batch, "cpu"),
                                     max_seq=S + 3)
    jlogits, jcache = jreg.prefill(jparams, jcfg, batch, max_seq=S + 3)
    _close(logits, jlogits)
    assert sorted(cache) == sorted(jcache) == ["image_kv", "self"]
    _close_tree(cache, jcache)
    ng, per_self = vlm.group_shape(cfg)
    assert tuple(cache["self"]["k"].shape) == (
        ng * per_self, 2, S + 3, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert tuple(cache["image_kv"]["k"].shape) == (
        ng, 2, cfg.n_image_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
    # decode reads the image K/V from the cache: no projection per token
    monkeypatch.setattr(vlm, "image_kv_from_embeds", None)
    rng = np.random.RandomState(5)
    for t in range(3):
        nxt = rng.randint(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        logits, cache = registry.decode_step(params, cfg, cache, S + t,
                                             torch.from_numpy(nxt))
        jlogits, jcache = jreg.decode_step(jparams, jcfg, jcache,
                                           jnp.int32(S + t), jnp.asarray(nxt))
        _close(logits, jlogits)
        _close_tree(cache, jcache)


def test_decode_matches_prefill():
    """Teacher-forced decode after a half prefill equals prefill
    position-wise (tests/test_arch_smoke.py:57-74)."""
    _, cfg, _, params = _models()
    batch = T.from_numpy(reduced_batch(cfg, 2, S), "cpu")
    toks = batch["tokens"]
    full, _ = registry.prefill(params, cfg, batch, max_seq=S)
    half = S // 2
    _, cache = registry.prefill(params, cfg,
                                dict(batch, tokens=toks[:, :half]), max_seq=S)
    for t in range(half, half + 3):
        logits, cache = registry.decode_step(params, cfg, cache, t,
                                             toks[:, t:t + 1])
        _close(logits[:, 0], full[:, t], rtol=2e-2, atol=2e-3)


def test_init_decode_cache_from_extras_then_decode_matches_reference():
    jcfg, cfg, jparams, params = _models()
    embeds = reduced_batch(cfg, 3, 8)["image_embeds"]
    cache = registry.init_decode_cache(
        params, cfg, 3, 12, batch_extras={"image_embeds":
                                          torch.from_numpy(embeds)})
    jcache = jreg.init_decode_cache(jparams, jcfg, 3, 12,
                                    batch_extras={"image_embeds": embeds})
    _close_tree(cache, jcache)
    assert not cache["self"]["k"].any()
    toks = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (3, 2)).astype(np.int32)
    for t in range(2):
        logits, cache = registry.decode_step(
            params, cfg, cache, t, torch.from_numpy(toks[:, t:t + 1]))
        jlogits, jcache = jreg.decode_step(jparams, jcfg, jcache, jnp.int32(t),
                                           jnp.asarray(toks[:, t:t + 1]))
        _close(logits, jlogits)
    _close_tree(cache, jcache)


def test_flash_reaches_only_the_self_layers(monkeypatch):
    """One kernel call per self layer, causal, at the token length: the
    cross layers never reach it."""
    from repro_torch.kernels import ops
    _, cfg, _, params = _models()
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal, **kw):
        calls.append((causal, q.shape[2], k.shape[2]))
        return real(q, k, v, causal=causal, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    batch = T.from_numpy(reduced_batch(cfg, 2, S), "cpu")
    registry.loss_fn(params, cfg.replace(use_flash_kernel=True), batch)
    ng, per_self = vlm.group_shape(cfg)
    assert calls == [(True, S, S)] * (ng * per_self)
    registry.prefill(params, cfg.replace(use_flash_kernel=True), batch)
    assert len(calls) == ng * per_self         # prefill goes through the cache


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(policy):
    """Remat over each group (its self layers and its cross layer) gives
    remat off's loss and grads."""
    _, cfg, _, params = _models()
    cfg = cfg.replace(use_flash_kernel=True)
    batch = T.from_numpy(reduced_batch(cfg, 2, 32), "cpu")
    vg = lambda c: T.value_and_grad(  # noqa: E731
        lambda p, b: registry.loss_fn(p, c, b))(params, batch)
    l0, g0 = vg(cfg)
    l1, g1 = vg(cfg.replace(remat=True, remat_policy=policy))
    assert float(l1) == float(l0)
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        assert torch.equal(a, b)



def _n_saved(cfg):
    """Tensors autograd keeps for the backward of one loss evaluation,
    outside any checkpointed region."""
    n = [0]

    def pack(x):
        n[0] += 1
        return x
    params = T.tree_map(lambda x: x.requires_grad_(True),
                        registry.init(0, cfg, "cpu"))
    batch = T.from_numpy(reduced_batch(cfg, 2, 32), "cpu")
    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        registry.loss_fn(params, cfg, batch)
    return n[0]


def test_remat_saves_fewer_tensors_for_backward():
    """Remat really wraps each group's body: one more group (its self
    layers and its cross layer) keeps far fewer tensors for the backward
    with remat "full" or "dots" on (only the checkpoint's own inputs stay
    outside it) than with it off. A remat_wrap that did nothing would
    keep as many."""
    base = reduced(ARCHS[ARCH])
    deeper = [dict(n_layers=base.n_layers + base.cross_attn_every)]
    for more in deeper:
        off = _n_saved(base.replace(**more)) - _n_saved(base)
        for remat in (dict(remat=True),
                      dict(remat=True, remat_policy="dots")):
            on = (_n_saved(base.replace(**more, **remat))
                  - _n_saved(base.replace(**remat)))
            assert 4 * on < off, (more, remat, on, off)

def test_llama_vision_param_counts():
    cfg = ARCHS[ARCH]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.cross_attn_every,
            cfg.n_image_tokens, cfg.d_vision) == (
                100, 8192, 64, 8, 128, 28_672, 5, 1600, 1280)
    assert registry.param_count(cfg) == 87_677_280_296
    assert registry.param_count(cfg) == jreg.param_count(J_ARCHS[ARCH])
    assert registry.param_bytes(cfg) == jreg.param_bytes(J_ARCHS[ARCH])
    # the depth the card runs: 4 groups of 4 self layers and 1 cross layer
    cut = cfg.replace(n_layers=20)
    assert vlm.group_shape(cut) == (4, 4)
    assert registry.param_count(cut) == 19_224_928_264
    assert registry.param_count(cut) == jreg.param_count(
        J_ARCHS[ARCH].replace(n_layers=20))
