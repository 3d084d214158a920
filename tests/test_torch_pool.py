"""The port's Fig. 5 semantic loop (``repro_torch.serverless``) against the
reference's ``LocalWorkerPool``: loss curves, store traffic, refresh
schedules, flatten order and shards, from the same weights and batches."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core.comm import CommSpec as JCommSpec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import apply_sgd as j_apply_sgd  # noqa: E402
from repro.serverless import LocalWorkerPool as JPool  # noqa: E402
from repro.serverless import ParamStore as JStore  # noqa: E402
from repro.serverless import worker as jworker  # noqa: E402
from repro_torch.configs import ARCHS, reduced, reduced_batch  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.core.comm import CommSpec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import apply_sgd  # noqa: E402
from repro_torch.serverless import LocalWorkerPool, ParamStore  # noqa: E402
from repro_torch.serverless import worker  # noqa: E402


def _stats(store):
    s = store.stats
    return (s.puts, s.gets, s.bytes_in, s.bytes_out)


def _olmo_setup():
    """tests/test_system.py::test_semantic_smlt_trains_real_model's setup."""
    jcfg = j_reduced(J_ARCHS["olmo-1b"]).replace(n_layers=1, d_model=64)
    cfg = reduced(ARCHS["olmo-1b"]).replace(n_layers=1, d_model=64)
    batch = reduced_batch(cfg, batch=8, seq=16)
    jparams = jreg.init(jax.random.key(0), jcfg)
    return jcfg, cfg, batch, jparams


@pytest.mark.parametrize("n_workers", [1, 4])
def test_loss_curve_matches_reference(n_workers):
    jcfg, cfg, batch, jparams = _olmo_setup()
    jgrad = jax.jit(lambda p, b: jax.grad(
        lambda q: jreg.loss_fn(q, jcfg, b))(p))
    jloss = jax.jit(lambda p, b: jreg.loss_fn(p, jcfg, b))
    jpool = JPool(jgrad, n_workers, JStore(), use_kernel=True)
    tpool = LocalWorkerPool(T.grad(lambda p, b: registry.loss_fn(p, cfg, b)),
                            n_workers, ParamStore(), use_kernel=True)
    jp = jparams
    tp = registry.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tb = T.from_numpy(batch, "cpu")
    jl, tl = [], []
    for _ in range(5):
        jl.append(float(jloss(jp, batch)))
        tl.append(float(registry.loss_fn(tp, cfg, tb)))
        jp = j_apply_sgd(jp, jpool.step(jp, batch), 0.1)
        tp = apply_sgd(tp, tpool.step(tp, tb), 0.1)
    assert tl[-1] < tl[0], "loss must decrease"
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert _stats(tpool.store) == _stats(jpool.store)


# a small linear model, as in tests/test_hier_sync.py
def _linear(seed, rows):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    batch = {"x": rng.randn(rows, 4).astype(np.float32),
             "y": rng.randn(rows, 3).astype(np.float32)}
    return params, batch


def _jgrad(p, b):
    return jax.grad(lambda q: jnp.mean((b["x"] @ q["w"] + q["b"]
                                        - b["y"]) ** 2))(p)


def _tgrad(p, b):
    return T.grad(lambda q, c: torch.mean((c["x"] @ q["w"] + q["b"]
                                           - c["y"]) ** 2))(p, b)


PLANS = [("scatter_reduce", None), ("ps", None), ("hier", None),
         ("compressed", 0.3), ("pipelined", None)]


def _plans(kind, ratio):
    if kind == "compressed":
        return JCommSpec("ps", ratio=ratio), CommSpec("ps", ratio=ratio)
    if kind == "pipelined":
        return (JCommSpec("scatter_reduce", pipeline_depth=3),
                CommSpec("scatter_reduce", pipeline_depth=3))
    return JCommSpec(kind), CommSpec(kind)


@pytest.mark.parametrize("kind,ratio", PLANS)
@pytest.mark.parametrize("sync_mode", ["bsp", "ssp(2)", "async"])
def test_strategies_and_sync_modes_match_reference(kind, ratio, sync_mode):
    """Every strategy under every sync mode: the same mean gradients, store
    traffic and per-worker refresh versions as the reference, step by
    step (SGD between steps, so stale snapshots differ from fresh ones)."""
    n = 4
    params, batch = _linear(7, 8 * n)
    jplan, tplan = _plans(kind, ratio)
    jpool = JPool(_jgrad, n, JStore(), plan=jplan, sync_mode=sync_mode,
                  seed=3, use_kernel=kind == "scatter_reduce")
    tpool = LocalWorkerPool(_tgrad, n, ParamStore(), plan=tplan,
                            sync_mode=sync_mode, seed=3,
                            use_kernel=kind == "scatter_reduce")
    jp = jax.tree.map(jnp.asarray, params)
    tp = T.from_numpy(params, "cpu")
    jb = jax.tree.map(jnp.asarray, batch)
    tb = T.from_numpy(batch, "cpu")
    for _ in range(6):
        jg = jpool.step(jp, jb)
        tg = tpool.step(tp, tb)
        assert tpool._vers == jpool._vers
        for a, b in zip(jax.tree.leaves(jg), T.leaves(tg)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
        jp = j_apply_sgd(jp, jg, 0.1)
        tp = apply_sgd(tp, tg, 0.1)
    assert _stats(tpool.store) == _stats(jpool.store)


@pytest.mark.parametrize("n_workers", [1, 2, 4, 8])
def test_pool_equals_fullbatch(n_workers):
    params, batch = _linear(n_workers, 8 * n_workers)
    tp, tb = T.from_numpy(params, "cpu"), T.from_numpy(batch, "cpu")
    g = LocalWorkerPool(_tgrad, n_workers, ParamStore()).step(tp, tb)
    ref = _tgrad(tp, tb)
    for a, b in zip(T.leaves(g), T.leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_kernel_aggregation_equals_plain_mean():
    params, batch = _linear(3, 16)
    tp, tb = T.from_numpy(params, "cpu"), T.from_numpy(batch, "cpu")
    g0 = LocalWorkerPool(_tgrad, 4, ParamStore()).step(tp, tb)
    g1 = LocalWorkerPool(_tgrad, 4, ParamStore(), use_kernel=True).step(tp, tb)
    for a, b in zip(T.leaves(g0), T.leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_flatten_order_and_shards_match_reference():
    """Shard j holds the same parameters at the same offsets in both
    packages (jax.tree.leaves order: keys sorted at every level)."""
    _, _, _, jparams = _olmo_setup()
    tp = registry.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jflat = jworker.flatten_grads(jparams)
    tflat = worker.flatten_grads(tp)
    np.testing.assert_array_equal(tflat.numpy(), jflat)
    for m in (1, 3, 4, 7):
        for a, b in zip(jworker.make_shards(jflat, m),
                        worker.make_shards(tflat, m)):
            np.testing.assert_array_equal(b.numpy(), a)
    back = worker.unflatten_grads(tflat, tp)
    for a, b in zip(T.leaves(back), T.leaves(tp)):
        assert torch.equal(a, b)
    shards = worker.make_shards(tflat, 5)
    assert torch.equal(worker.join_shards(shards, tflat.numel()), tflat)


def test_parse_sync_mode_matches_reference():
    for m in ("bsp", "ssp", "ssp(3)", "async", " SSP(1) "):
        assert worker.parse_sync_mode(m, 2) == jworker.parse_sync_mode(m, 2)
    with pytest.raises(ValueError):
        worker.parse_sync_mode("sometimes")


def test_store_drops_payloads_after_the_step():
    params, batch = _linear(0, 16)
    store = ParamStore()
    LocalWorkerPool(_tgrad, 4, store).step(T.from_numpy(params, "cpu"),
                                           T.from_numpy(batch, "cpu"))
    assert store.blobs == {} and store.stats.puts == 4 * 4 + 4
