"""The port's hybrid family (``repro_torch.models.hybrid``, zamba2-7b)
against the reference on reduced zamba2-7b in f32: the same numpy inputs,
the reference's weights carried across with ``params_from_numpy``. The
reference's kernels run in Pallas interpret mode, as its own tests run
them. Tolerances: loss rtol 1e-5 and, kernels on against off, rtol 1e-4
(``tests/test_kernel_integration.py:43-52``); grads rtol 5e-4 / atol 1e-5;
ring-cache decode through three wraps of the window within 5e-3 of the
windowed full forward (``tests/test_hybrid_window.py``). Logits and
caches against the reference: rtol 1e-4 / atol 5e-5 (f32 sums taken in
another order through five SSM layers and two shared-block sites move a
few logits of size ~1 by 1e-5 to 2e-5)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCHS, reduced, reduced_batch  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.models import hybrid as hy  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

ARCH = "zamba2-7b"
WINDOW = 16
S_TOTAL = 48  # decode well past the window: three wraps of the ring


@functools.lru_cache(maxsize=None)
def _models(seed=0, window=None):
    jcfg = j_reduced(J_ARCHS[ARCH])
    cfg = reduced(ARCHS[ARCH])
    if window:
        jcfg = jcfg.replace(sliding_window=window)
        cfg = cfg.replace(sliding_window=window)
    jparams = jreg.init(jax.random.key(seed), jcfg)
    params = registry.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, cfg, jparams, params


def _close(got, want, rtol=1e-4, atol=5e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@functools.lru_cache(maxsize=None)
def _ref_loss(kernels: bool):
    jcfg, _, jparams, _ = _models()
    batch = reduced_batch(jcfg, 2, 64)
    return float(jreg.loss_fn(jparams, jcfg.replace(
        use_flash_kernel=kernels, use_ssd_kernel=kernels), batch))


@pytest.mark.parametrize("kernels", [False, True])
def test_loss_matches_reference(kernels):
    _, cfg, _, params = _models()
    batch = T.from_numpy(reduced_batch(cfg, 2, 64), "cpu")
    got = float(registry.loss_fn(params, cfg.replace(
        use_flash_kernel=kernels, use_ssd_kernel=kernels), batch))
    np.testing.assert_allclose(got, _ref_loss(kernels), rtol=1e-5)
    # the reference's own gate check: both kernels on == both off
    np.testing.assert_allclose(got, _ref_loss(not kernels), rtol=1e-4)


def test_grads_match_reference():
    jcfg, cfg, jparams, params = _models(seed=1)
    batch = reduced_batch(cfg, 2, 32)
    jg = jax.grad(lambda p: jreg.loss_fn(p, jcfg, batch))(jparams)
    g = T.grad(lambda p, b: registry.loss_fn(p, cfg, b))(
        params, T.from_numpy(batch, "cpu"))
    jl, tl = jax.tree.leaves(jg), T.leaves(g)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b, a, rtol=5e-4, atol=1e-5)


def test_prefill_and_four_decode_steps_match_reference():
    jcfg, cfg, jparams, params = _models()
    batch = reduced_batch(cfg, 2, 24)
    toks = T.from_numpy(batch, "cpu")["tokens"]
    logits, cache = registry.prefill(params, cfg, {"tokens": toks},
                                     max_seq=28)
    jlogits, jcache = jreg.prefill(jparams, jcfg, batch, max_seq=28)
    _close(logits, jlogits)
    for part in ("mamba", "attn"):
        assert sorted(cache[part]) == sorted(jcache[part])
        for k in cache[part]:
            assert cache[part][k].shape == jcache[part][k].shape
            _close(cache[part][k], jcache[part][k])
    rng = np.random.RandomState(5)
    for t in range(4):
        nxt = rng.randint(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        logits, cache = registry.decode_step(params, cfg, cache, 24 + t,
                                             torch.from_numpy(nxt))
        jlogits, jcache = jreg.decode_step(jparams, jcfg, jcache,
                                           jnp.int32(24 + t), jnp.asarray(nxt))
        _close(logits, jlogits)
        _close(cache["attn"]["k"], jcache["attn"]["k"])


def test_ring_cache_wraparound_matches_windowed_attention():
    """Prefill half the window, then decode one token at a time through
    three wraps of the ring: every step's logits within 5e-3 of the
    windowed full forward, the port's and the reference's."""
    jcfg, cfg, jparams, params = _models(window=WINDOW)
    toks_np = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, S_TOTAL)).astype(np.int32)
    toks = torch.from_numpy(toks_np)
    full, _ = registry.prefill(params, cfg, {"tokens": toks},
                               max_seq=S_TOTAL)
    jfull, _ = jreg.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks_np)},
                            max_seq=S_TOTAL)
    _close(full, jfull)
    start = WINDOW // 2
    _, cache = registry.prefill(params, cfg, {"tokens": toks[:, :start]},
                                max_seq=S_TOTAL)
    assert cache["attn"]["k"].shape[2] == WINDOW
    max_diff = 0.0
    for t in range(start, S_TOTAL):
        logits, cache = registry.decode_step(params, cfg, cache, t,
                                             toks[:, t:t + 1])
        max_diff = max(max_diff,
                       float((full[:, t] - logits[:, 0]).abs().max()))
    assert max_diff < 5e-3, max_diff


def test_ring_cache_is_window_sized():
    _, cfg, _, params = _models(window=WINDOW)
    cache = registry.init_decode_cache(params, cfg, batch=2, max_seq=1 << 16)
    # attention K/V allocated at window size, not 64k: O(window) memory
    assert cache["attn"]["k"].shape[2] == WINDOW
    assert cache["attn"]["k"].shape[0] == hy.n_groups(cfg)[0]


def test_prefill_ring_slots_hold_the_last_window():
    """Prefill longer than the window: slot t mod window holds position
    t's keys for the last window positions, as the reference fills it."""
    jcfg, cfg, jparams, params = _models(window=WINDOW)
    toks_np = reduced_batch(cfg, 2, 37)["tokens"]
    _, cache = registry.prefill(params, cfg,
                                {"tokens": torch.from_numpy(toks_np)},
                                max_seq=64)
    _, jcache = jreg.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks_np)},
                             max_seq=64)
    _close(cache["attn"]["k"], jcache["attn"]["k"])
    _close(cache["attn"]["v"], jcache["attn"]["v"])


def test_init_decode_cache_matches_reference_shapes():
    jcfg, cfg, _, params = _models()
    got = registry.init_decode_cache(params, cfg, 3, 20)
    want = jreg.init_decode_cache(None, jcfg, 3, 20)
    for part in ("mamba", "attn"):
        assert sorted(got[part]) == sorted(want[part])
        for k in got[part]:
            assert tuple(got[part][k].shape) == tuple(want[part][k].shape)
            assert not got[part][k].any()


def test_greedy_tokens_match_reference_engine():
    jcfg, cfg, jparams, params = _models()
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


def test_zamba2_full_width_param_count():
    cfg = ARCHS[ARCH]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
            cfg.attn_every, cfg.sliding_window, cfg.ssm_nheads,
            cfg.ssm_state) == (81, 3584, 32, 112, 6, 4096, 112, 64)
    assert hy.n_groups(cfg) == (13, 3)
    assert registry.param_count(cfg) == 6_750_539_856
    assert registry.param_count(cfg) == jreg.param_count(J_ARCHS[ARCH])
    assert registry.param_bytes(cfg) == jreg.param_bytes(J_ARCHS[ARCH])


def _faulty(fault, fn):
    """ops.flash_attention or ops.ssd_scan computing another function."""
    if fault == "ssd_bc_swap":
        return lambda x, dt, A, B, C, D, *, chunk: fn(x, dt, A, C, B, D,
                                                      chunk=chunk)
    return lambda q, k, v, *, causal, window, **kw: fn(
        q, k, v, causal=causal, window=window // 4, **kw)


@pytest.mark.parametrize("fault", [None, "ssd_bc_swap", "flash_window"])
def test_smoke_holds_each_kernel_call_against_its_plain_version(
        fault, monkeypatch):
    """chip_smoke.py's phase 12 hold passes every kernel call of the model
    and fails a kernel that computes another function of its inputs."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    _, cfg, _, params = _models()
    on = cfg.replace(use_flash_kernel=True, use_ssd_kernel=True)
    toks = torch.from_numpy(np.asarray(
        reduced_batch(cfg, 2, 64)["tokens"])).long()
    if fault:
        name = "ssd_scan" if fault == "ssd_bc_swap" else "flash_attention"
        monkeypatch.setattr(ops, name, _faulty(fault, getattr(ops, name)))
    before = (ops.flash_attention, ops.ssd_scan)
    calls = []
    with cs.held_against_plain(calls), torch.no_grad():
        if fault:
            with pytest.raises(RuntimeError, match="inside the model"):
                hy.forward_full(params, on, toks)
        else:
            hy.forward_full(params, on, toks)
    if not fault:
        assert [n for n, _ in calls].count("ssd_scan") == cfg.n_layers
        assert [n for n, _ in calls].count("flash_attention") == \
            hy.n_groups(cfg)[0]
        assert all(r == 0.0 for _, r in calls)   # the CPU runs plain
    assert (ops.flash_attention, ops.ssd_scan) == before   # restored


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(policy):
    """Remat on (per group of attn_every Mamba2 layers and the shared
    block, as the reference; the remainder layers without) gives the loss
    and grads of remat off."""
    _, cfg, _, params = _models()
    batch = T.from_numpy(reduced_batch(cfg, 2, 32), "cpu")
    vg = lambda c: T.value_and_grad(  # noqa: E731
        lambda p, b: registry.loss_fn(p, c, b))(params, batch)
    l0, g0 = vg(cfg)
    l1, g1 = vg(cfg.replace(remat=True, remat_policy=policy))
    assert float(l1) == float(l0)
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        assert torch.equal(a, b)
