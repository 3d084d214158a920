"""The port's SSM family (``repro_torch.models.mamba2``) against the
reference on reduced mamba2-2.7b in f32: the same numpy inputs, the
reference's weights carried across with ``params_from_numpy``. The
reference's SSD kernel runs in Pallas interpret mode, as its own tests run
it. Tolerances: loss rtol 1e-5, grads rtol 5e-4 / atol 1e-5 (those of
``tests/test_kernel_integration.py``), the SSD pieces rtol 1e-5."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import ARCHS, reduced, reduced_batch  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import mamba2 as m  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ARCH = "mamba2-2.7b"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@functools.lru_cache(maxsize=None)
def _models(seed=0):
    jcfg = j_reduced(J_ARCHS[ARCH])
    cfg = reduced(ARCHS[ARCH])
    jparams = jreg.init(jax.random.key(seed), jcfg)
    params = registry.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, cfg, jparams, params


def _ssm_inputs(rng, b, s, h, p, n):
    return (rng.randn(b, s, h, p).astype(np.float32),
            (np.abs(rng.randn(b, s, h)) * 0.5 + 0.01).astype(np.float32),
            -(np.abs(rng.randn(h)) + 0.5).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            rng.randn(h).astype(np.float32))


# ---------------------------------------------------------------------------
# the SSD pieces
# ---------------------------------------------------------------------------


def test_ref_ssd_matches_reference():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    args = _ssm_inputs(np.random.RandomState(0), 2, 40, 3, 8, 4)
    y, S = ref.ref_ssd(*map(_t, args))
    jy, jS = jref.ref_ssd(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s,chunk", [(48, 16), (50, 16)])
def test_ssd_chunked_with_initial_state_matches_reference(s, chunk):
    rng = np.random.RandomState(1)
    args = _ssm_inputs(rng, 2, s, 3, 8, 4)
    s0 = rng.randn(2, 3, 4, 8).astype(np.float32)
    y, S = m.ssd_chunked(*map(_t, args), chunk, initial_state=_t(s0))
    jy, jS = jm.ssd_chunked(*map(jnp.asarray, args), chunk,
                            initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-5,
                               atol=1e-5)


def test_ssd_chunked_equals_the_sequential_recurrence():
    """Chunked with a carried state == the per-token definition run over
    both halves (test_models_ref's continuation check)."""
    from repro_torch.kernels import ref
    args = [_t(a) for a in _ssm_inputs(np.random.RandomState(2), 1, 64, 2,
                                       8, 4)]
    want_y, want_S = ref.ref_ssd(*args)
    first = [a[:, :40] if a.dim() > 1 else a for a in args]
    rest = [a[:, 40:] if a.dim() > 1 else a for a in args]
    y1, S1 = m.ssd_chunked(*first, 16)
    y2, S2 = m.ssd_chunked(*rest, 16, initial_state=S1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               want_y.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(S2.numpy(), want_S.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_causal_conv_with_carried_state_matches_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 6).astype(np.float32)
    w = rng.randn(4, 6).astype(np.float32)
    state = rng.randn(2, 3, 6).astype(np.float32)
    for st in (None, state):
        out, new = m.causal_conv(_t(x), _t(w), None if st is None else _t(st))
        jout, jnew = jm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    None if st is None else jnp.asarray(st))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


def test_ssd_decode_step_matches_reference():
    rng = np.random.RandomState(4)
    b, h, p, n = 2, 3, 8, 4
    S = rng.randn(b, h, n, p).astype(np.float32)
    x = rng.randn(b, h, p).astype(np.float32)
    dt = (np.abs(rng.randn(b, h)) * 0.5).astype(np.float32)
    A = -(np.abs(rng.randn(h)) + 0.5).astype(np.float32)
    B, C = rng.randn(b, n).astype(np.float32), rng.randn(b, n).astype(np.float32)
    D = rng.randn(h).astype(np.float32)
    args = (S, x, dt, A, B, C, D)
    y, S2 = m.ssd_decode_step(*map(_t, args))
    jy, jS2 = jm.ssd_decode_step(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(S2.numpy(), np.asarray(jS2), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# reduced mamba2-2.7b against the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_loss(kernel: bool):
    jcfg, _, jparams, _ = _models()
    batch = reduced_batch(jcfg, 2, 48)
    return float(jreg.loss_fn(jparams, jcfg.replace(use_ssd_kernel=kernel),
                              batch))


@pytest.mark.parametrize("kernel", [False, True])
def test_loss_matches_reference(kernel):
    _, cfg, _, params = _models()
    batch = T.from_numpy(reduced_batch(cfg, 2, 48), "cpu")
    got = float(registry.loss_fn(params, cfg.replace(use_ssd_kernel=kernel),
                                 batch))
    np.testing.assert_allclose(got, _ref_loss(kernel), rtol=1e-5)
    # the reference's own gate check (test_kernel_integration.py:34-40)
    np.testing.assert_allclose(got, _ref_loss(not kernel), rtol=1e-4)


def test_grads_match_reference():
    jcfg, cfg, jparams, _ = _models(seed=1)
    _, _, _, params = _models(seed=1)
    batch = reduced_batch(cfg, 2, 32)
    jg = jax.grad(lambda p: jreg.loss_fn(p, jcfg, batch))(jparams)
    g = T.grad(lambda p, b: registry.loss_fn(p, cfg, b))(
        params, T.from_numpy(batch, "cpu"))
    jl, tl = jax.tree.leaves(jg), T.leaves(g)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=5e-4,
                                   atol=1e-5)


def test_prefill_and_four_decode_steps_match_reference():
    jcfg, cfg, jparams, params = _models()
    batch = reduced_batch(cfg, 2, 24)
    toks = T.from_numpy(batch, "cpu")["tokens"]
    logits, cache = registry.prefill(params, cfg, {"tokens": toks})
    jlogits, jcache = jreg.prefill(jparams, jcfg, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    for k in ("conv_x", "conv_BC", "ssm"):
        assert cache[k].shape == jcache[k].shape
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=1e-4, atol=1e-5)
    rng = np.random.RandomState(5)
    for t in range(4):
        nxt = rng.randint(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        logits, cache = registry.decode_step(params, cfg, cache, 24 + t,
                                             torch.from_numpy(nxt))
        jlogits, jcache = jreg.decode_step(jparams, jcfg, jcache,
                                           jnp.int32(24 + t), jnp.asarray(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-5)


def test_one_token_prefill_takes_the_recurrence():
    """A prompt of one token has a cache and one position, so each block
    takes the recurrence (``ssd_decode_step``): its logits and cache
    against the reference's prefill, which runs its chunked form."""
    jcfg, cfg, jparams, params = _models()
    batch = reduced_batch(cfg, 2, 1)
    logits, cache = registry.prefill(
        params, cfg, {"tokens": T.from_numpy(batch, "cpu")["tokens"]})
    jlogits, jcache = jreg.prefill(jparams, jcfg, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    for k in ("conv_x", "conv_BC", "ssm"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=1e-4, atol=1e-5)


def test_decode_after_prefill_matches_full_forward():
    """prefill(tokens[:, :-k]) then k decode steps == prefill(tokens)."""
    _, cfg, _, params = _models()
    toks = T.from_numpy(reduced_batch(cfg, 2, 40), "cpu")["tokens"]
    full, _ = registry.prefill(params, cfg, {"tokens": toks})
    kern, _ = m.forward(params, cfg.replace(use_ssd_kernel=True), toks)
    np.testing.assert_allclose(kern.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-5)
    _, cache = registry.prefill(params, cfg, {"tokens": toks[:, :37]})
    for t in range(37, 40):
        logits, cache = registry.decode_step(params, cfg, cache, t,
                                             toks[:, t:t + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-5)


def _ssd_counts(fn):
    """The ``ssd.*`` counter records made while ``fn()`` runs, as
    (name, value) pairs, and its result."""
    from repro_torch.core import spans
    spans.clear()
    with spans.recording():
        out = fn()
    got = [(c.name, c.value) for c in spans.counted()
           if c.name.startswith("ssd.")]
    spans.clear()
    return got, out


@pytest.mark.parametrize("kernel", [True, False])
def test_zero_state_prefill_takes_the_kernel_once_a_layer(kernel,
                                                          monkeypatch):
    """A prefill starts from the zero state, which it states: under
    ``use_ssd_kernel`` every block calls ``kops.ssd_scan`` once and
    ``ssd_chunked`` never, and counts ``ssd.kernel``; without it every
    block takes ``ssd_chunked`` and counts ``ssd.chunked``."""
    from repro_torch.kernels import ops as kops
    _, cfg, _, params = _models()
    cfg = cfg.replace(use_ssd_kernel=kernel)
    calls = []
    for mod, name in ((kops, "ssd_scan"), (m, "ssd_chunked")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    toks = torch.from_numpy(reduced_batch(cfg, 2, 37)["tokens"])
    got, _ = _ssd_counts(lambda: m.prefill(params, cfg, toks))
    want = "ssd_scan" if kernel else "ssd_chunked"
    assert calls == [want] * cfg.n_layers
    assert got == [("ssd.kernel" if kernel else "ssd.chunked", 1)] \
        * cfg.n_layers


def test_continuation_and_decode_keep_their_paths():
    """Under ``use_ssd_kernel`` a forward that carries a prefill's state
    (not stated as zero) takes ``ssd_chunked``, and a one-token decode
    step the recurrence, which counts nothing; with spans off nothing is
    counted at all."""
    from repro_torch.core import spans
    _, cfg, _, params = _models()
    cfg = cfg.replace(use_ssd_kernel=True)
    toks = torch.from_numpy(reduced_batch(cfg, 2, 40)["tokens"])
    _, cache = m.prefill(params, cfg, toks[:, :30])
    assert spans.counted() == []
    got, _ = _ssd_counts(lambda: m.forward(params, cfg, toks[:, 30:39],
                                           cache=cache))
    assert got == [("ssd.chunked", 1)] * cfg.n_layers
    got, _ = _ssd_counts(lambda: m.decode_step(params, cfg, cache, 30,
                                               toks[:, 30:31]))
    assert got == []


@pytest.mark.parametrize("s", [37, 300])
def test_kernel_prefill_matches_reference(s):
    """The prefill through the SSD kernel (its plain version on the CPU) at
    prompt lengths that are not multiples of the chunk: the logits and
    every cache leaf against the reference's prefill, which runs its
    chunked form."""
    jcfg, cfg, jparams, params = _models()
    batch = reduced_batch(cfg, 2, s)
    got, (logits, cache) = _ssd_counts(lambda: registry.prefill(
        params, cfg.replace(use_ssd_kernel=True),
        {"tokens": T.from_numpy(batch, "cpu")["tokens"]}))
    assert got == [("ssd.kernel", 1)] * cfg.n_layers
    jlogits, jcache = jreg.prefill(jparams, jcfg, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    for k in ("conv_x", "conv_BC", "ssm"):
        assert cache[k].shape == jcache[k].shape
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fault", [None, "ssd_bc_swap"])
def test_smoke_holds_each_serving_prefill_kernel_call(fault, monkeypatch):
    """chip_smoke.py's hold of the serving prefill (phases 9 and 13) passes
    every SSD call of a prefill from the zero state, one a layer, and
    fails a kernel that computes another function of its inputs."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from repro_torch.kernels import ops as kops
    _, cfg, _, params = _models()
    cfg = cfg.replace(use_ssd_kernel=True)
    if fault:
        scan = kops.ssd_scan
        monkeypatch.setattr(kops, "ssd_scan", lambda x, dt, A, B, C, D, *,
                            chunk: scan(x, dt, A, C, B, D, chunk=chunk))
    before, held = kops.ssd_scan, []
    if fault:
        with pytest.raises(RuntimeError, match="inside the model"):
            cs.run_serving(cfg, params, torch.device("cpu"), 2, 64, 3,
                           held=held)
    else:
        cs.run_serving(cfg, params, torch.device("cpu"), 2, 64, 3,
                       held=held)
        assert held == [("ssd_scan", 0.0)] * cfg.n_layers   # plain on CPU
    assert kops.ssd_scan is before                          # restored


def test_init_decode_cache_matches_reference_shapes():
    for arch in (ARCH, "olmo-1b"):
        jcfg, cfg = j_reduced(J_ARCHS[arch]), reduced(ARCHS[arch])
        params = registry.init(0, cfg, "cpu")
        got = registry.init_decode_cache(params, cfg, 3, 20)
        want = jreg.init_decode_cache(None, jcfg, 3, 20)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert got[k].device.type == "cpu" and not got[k].any()


# ---------------------------------------------------------------------------
# the full-width configuration and the kernel's boundaries
# ---------------------------------------------------------------------------


def test_mamba2_full_width_param_count():
    cfg = ARCHS[ARCH]
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_nheads, cfg.ssm_headdim,
            cfg.ssm_state, cfg.ssm_chunk, cfg.dtype) == (
        64, 2560, 80, 64, 128, 256, torch.bfloat16)
    assert registry.param_count(cfg) == 2_702_296_576
    assert registry.param_count(cfg) == jreg.param_count(J_ARCHS[ARCH])
    assert registry.param_bytes(cfg) == jreg.param_bytes(J_ARCHS[ARCH])


def test_init_keys_shapes_and_ranges_match_reference():
    jcfg, cfg, jparams, _ = _models()
    mine = registry.init(3, cfg, "cpu")
    jl = jax.tree.leaves_with_path(jparams)
    assert [jax.tree_util.keystr(k) for k, _ in jl] == [
        "".join(f"['{p}']" for p in path) for path in _paths(mine)]
    for (_, a), b in zip(jl, T.leaves(mine)):
        assert tuple(a.shape) == tuple(b.shape)
    a_log = mine["blocks"]["A_log"]
    assert bool((a_log >= 0).all() and (a_log <= np.log(16.0)).all())


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def test_ssd_kernel_refuses_requires_grad_before_launch():
    """On a non-CPU tensor (meta stands in for CUDA) an input that requires
    grad raises before the kernel library is even loaded."""
    x = torch.empty(1, 32, 2, 16, device="meta", requires_grad=True)
    dt = torch.empty(1, 32, 2, device="meta")
    hv = torch.empty(2, device="meta")
    bc = torch.empty(1, 32, 8, device="meta")
    before = ssd.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        ssd.ssd_scan(x, dt, hv, bc, bc, hv, chunk=16)
    assert ssd.LAUNCHES == before


def test_remat_is_refused():
    """Remat was refused before it was ported (the name is kept): now the
    cached path (prefill, no grad) with remat on returns the logits and
    cache of remat off, under both policies."""
    _, cfg, _, params = _models()
    toks = torch.from_numpy(reduced_batch(cfg, 2, 32)["tokens"])
    with torch.no_grad():
        want = m.prefill(params, cfg, toks)
        for policy in ("full", "dots"):
            got = m.prefill(params, cfg.replace(remat=True,
                                                remat_policy=policy), toks)
            for a, b in zip([got[0]] + T.leaves(got[1]),
                            [want[0]] + T.leaves(want[1])):
                assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(policy):
    _, cfg, _, params = _models()
    batch = T.from_numpy(reduced_batch(cfg, 2, 32), "cpu")
    vg = lambda c: T.value_and_grad(  # noqa: E731
        lambda p, b: registry.loss_fn(p, c, b))(params, batch)
    l0, g0 = vg(cfg)
    l1, g1 = vg(cfg.replace(remat=True, remat_policy=policy))
    assert float(l1) == float(l0)
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        assert torch.equal(a, b)
