"""The port's MoE family (``repro_torch.models.moe``) against the reference
on reduced qwen2-moe-a2.7b and arctic-480b in f32: the same numpy inputs,
the reference's weights carried across with ``params_from_numpy``.
Tolerances: loss (the router's aux loss included) rtol 1e-5, grads rtol
5e-4 / atol 1e-5 (``tests/test_kernel_integration.py``); a dispatch group
rtol 1e-5 / atol 1e-6; logits rtol 1e-4 / atol 5e-5."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCHS, reduced, reduced_batch  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

MOE = ["qwen2-moe-a2.7b", "arctic-480b"]


@functools.lru_cache(maxsize=None)
def _models(arch, seed=0, **kw):
    jcfg = j_reduced(J_ARCHS[arch]).replace(**kw)
    cfg = reduced(ARCHS[arch]).replace(**kw)
    jparams = jreg.init(jax.random.key(seed), jcfg)
    params = registry.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, cfg, jparams, params


def _close(got, want, rtol=1e-4, atol=5e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _layer0(tree):
    """The first layer's MoE FFN parameters of a stacked tree."""
    return T.tree_map(lambda x: x[0], tree["blocks"]["moe"])


@pytest.mark.parametrize("arch", MOE)
def test_loss_matches_reference(arch):
    jcfg, cfg, jparams, params = _models(arch)
    batch = reduced_batch(cfg, 2, 64)
    got = registry.loss_fn(params, cfg, T.from_numpy(batch, "cpu"))
    want = jreg.loss_fn(jparams, jcfg, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the aux loss alone, summed over the layers
    _, _, aux = moe.forward(params, cfg, T.from_numpy(batch, "cpu")["tokens"])
    _, _, jaux = jmoe.forward(jparams, jcfg, jnp.asarray(batch["tokens"]))
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_grads_match_reference(arch):
    jcfg, cfg, jparams, params = _models(arch, seed=1)
    batch = reduced_batch(cfg, 2, 32)
    jg = jax.grad(lambda p: jreg.loss_fn(p, jcfg, batch))(jparams)
    g = T.grad(lambda p, b: registry.loss_fn(p, cfg, b))(
        params, T.from_numpy(batch, "cpu"))
    jl, tl = jax.tree.leaves(jg), T.leaves(g)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b, a, rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("arch,pad", [("qwen2-moe-a2.7b", 0),
                                      ("qwen2-moe-a2.7b", 6),
                                      ("arctic-480b", 0)])
@pytest.mark.parametrize("capacity", [0.5, 2.0])
def test_dispatch_group_matches_reference(arch, pad, capacity):
    """One dispatch group, by index, against the reference's one-hot
    ``_moe_group`` and the port's own one-hot form: the same output and
    aux loss. At capacity factor 0.5 the experts overflow and drop
    (token, slot) pairs; padded experts (``moe_pad_experts``) are never
    routed to."""
    jcfg, cfg, jparams, params = _models(arch, moe_capacity_factor=capacity,
                                         moe_pad_experts=pad)
    xt = np.random.RandomState(2).randn(48, cfg.d_model).astype(np.float32)
    p = _layer0(params)
    got, aux = moe._moe_group(p, cfg, torch.from_numpy(xt))
    jout, jaux = jmoe._moe_group(jax.tree.map(lambda x: x[0],
                                              jparams["blocks"]["moe"]),
                                 jcfg, jnp.asarray(xt))
    _close(got, jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    plain, plain_aux = moe._moe_group_onehot(p, cfg, torch.from_numpy(xt))
    _close(got, plain.numpy(), rtol=1e-5, atol=1e-6)
    assert float(aux) == float(plain_aux)
    gate_idx, _, keep, _, _, _ = moe._route(p, cfg, torch.from_numpy(xt))
    assert int(gate_idx.max()) < cfg.n_experts
    assert bool(keep.all()) == (capacity == 2.0)   # 0.5 drops some


def test_groups_split_the_tokens_as_the_reference_does():
    """moe_group 32 over 2 x 64 tokens: four groups, each with its own
    capacity, and the aux loss their mean."""
    jcfg, cfg, jparams, params = _models("qwen2-moe-a2.7b", moe_group=32,
                                         moe_capacity_factor=0.5)
    batch = reduced_batch(cfg, 2, 64)
    got = registry.loss_fn(params, cfg, T.from_numpy(batch, "cpu"))
    want = jreg.loss_fn(jparams, jcfg, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_prefill_and_four_decode_steps_match_reference():
    jcfg, cfg, jparams, params = _models("qwen2-moe-a2.7b")
    batch = reduced_batch(cfg, 2, 24)
    toks = T.from_numpy(batch, "cpu")["tokens"]
    logits, cache = registry.prefill(params, cfg, {"tokens": toks},
                                     max_seq=28)
    jlogits, jcache = jreg.prefill(jparams, jcfg, batch, max_seq=28)
    _close(logits, jlogits)
    for k in ("k", "v"):
        assert cache[k].shape == jcache[k].shape
        _close(cache[k], jcache[k])
    rng = np.random.RandomState(5)
    for t in range(4):
        nxt = rng.randint(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        logits, cache = registry.decode_step(params, cfg, cache, 24 + t,
                                             torch.from_numpy(nxt))
        jlogits, jcache = jreg.decode_step(jparams, jcfg, jcache,
                                           jnp.int32(24 + t), jnp.asarray(nxt))
        _close(logits, jlogits)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_tokens_match_reference_engine(arch):
    """Not batching-invariant (capacity depends on the batch), so the
    tokens are held to the reference engine's on the same batch."""
    jcfg, cfg, jparams, params = _models(arch)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(3)]
    got = ServingEngine(cfg, params=params, device="cpu").serve_batch(
        [Request(i, p, 6) for i, p in enumerate(prompts)])
    want = JEngine(jcfg, params=jparams).serve_batch(
        [JRequest(i, p, 6) for i, p in enumerate(prompts)])
    for g, w in zip(got, want):
        assert g.rid == w.rid
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_init_decode_cache_matches_reference_shapes():
    jcfg, cfg, _, params = _models("qwen2-moe-a2.7b")
    got = registry.init_decode_cache(params, cfg, 3, 20)
    want = jreg.init_decode_cache(None, jcfg, 3, 20)
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert not got[k].any()


@pytest.mark.parametrize("arch,total,active", [
    ("qwen2-moe-a2.7b", 14_315_735_040, 2_689_124_352),
    ("arctic-480b", 476_850_275_328, 15_584_314_368)])
def test_full_width_param_count(arch, total, active):
    """On the meta device: nothing is allocated."""
    cfg = ARCHS[arch]
    assert registry.param_count(cfg) == total == jreg.param_count(
        J_ARCHS[arch])
    assert registry.param_count(cfg, active_only=True) == active == \
        jreg.param_count(J_ARCHS[arch], active_only=True)
    assert registry.param_bytes(cfg) == jreg.param_bytes(J_ARCHS[arch])


def test_init_keys_and_shapes_match_reference():
    _, cfg, jparams, _ = _models("qwen2-moe-a2.7b")
    mine = registry.init(3, cfg, "cpu")
    jl = jax.tree.leaves(jparams)
    tl = T.leaves(mine)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
    assert jax.tree.structure(jax.tree.map(np.asarray, jparams)) == \
        jax.tree.structure(T.tree_map(lambda x: 0, mine))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", MOE)
def test_remat_matches_no_remat(arch, policy):
    """Remat on (per layer, the aux loss summed outside the recompute)
    gives the loss and grads of remat off."""
    _, cfg, _, params = _models(arch)
    batch = T.from_numpy(reduced_batch(cfg, 2, 32), "cpu")
    vg = lambda c: T.value_and_grad(  # noqa: E731
        lambda p, b: registry.loss_fn(p, c, b))(params, batch)
    l0, g0 = vg(cfg)
    l1, g1 = vg(cfg.replace(remat=True, remat_policy=policy))
    assert float(l1) == float(l0)
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        assert torch.equal(a, b)
