"""The port's optimizer, schedules and data stream against the reference,
plus its boundaries: it imports neither JAX nor the reference package, and
its entry points default to CUDA without falling back to the CPU."""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import ShardedLoader as JLoader  # noqa: E402
from repro.data.pipeline import TokenDataset as JDataset  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import DataConfig, OnlineStream, ShardedLoader, TokenDataset  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_twenty_updates_match_reference(dtype):
    rng = np.random.RandomState(0)
    params = {
        "a": rng.randn(7, 5).astype(np.float32),
        "blk": {"w": rng.randn(3, 4, 6).astype(np.float32),
                "b": rng.randn(6).astype(np.float32)}}
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jp = jax.tree.map(lambda x: jnp.asarray(x, jd), params)
    tp = registry.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(lr=1e-2, weight_decay=0.1)
    jopt = JAdamW(schedule=j_warmup_cosine(5, 20), **kw)
    topt = AdamW(schedule=warmup_cosine(5, 20), **kw)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(20):
        scale = 5.0 if step % 3 == 0 else 0.05     # clip some steps, not all
        grads = jax.tree.map(
            lambda x: (rng.randn(*x.shape) * scale).astype(np.float32),
            params)
        jp, js = jopt.update(jax.tree.map(lambda g: jnp.asarray(g, jd), grads),
                             js, jp)
        tp, ts = topt.update(
            registry.params_from_numpy(jax.tree.map(
                lambda g: np.asarray(jnp.asarray(g, jd)), grads), "cpu"),
            ts, tp)
    assert ts.step == int(js.step) == 20
    rtol = 1e-5 if dtype == "f32" else 1e-2
    for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   rtol=rtol, atol=rtol * 1e-1)
    for a, b in zip(jax.tree.leaves(js.mu), T.leaves(ts.mu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)


def test_warmup_cosine_matches_reference():
    j, t = j_warmup_cosine(10, 100, 0.2), warmup_cosine(10, 100, 0.2)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6, atol=1e-7)


def test_token_stream_is_bit_identical():
    for seed in (0, 5):
        jl = JLoader(JDataset(JDataConfig(vocab_size=50_304, seq_len=64,
                                          dataset_tokens=64 * 20, seed=seed)))
        tl = ShardedLoader(TokenDataset(DataConfig(
            vocab_size=50_304, seq_len=64, dataset_tokens=64 * 20,
            seed=seed)))
        for _ in range(4):                      # crosses an epoch boundary
            a, b = jl.next_batch(8), tl.next_batch(8)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
            assert b["tokens"].dtype == np.int32
        assert (jl.state.epoch, jl.state.index) == \
            (tl.state.epoch, tl.state.index)


def test_online_stream_matches_reference():
    from repro.data.pipeline import OnlineStream as JOnline
    a, b = JOnline(100.0, seed=3), OnlineStream(100.0, seed=3)
    assert [a.arrivals(t, 60.0) for t in range(0, 3600, 600)] == \
        [b.arrivals(t, 60.0) for t in range(0, 3600, 600)]


# ---------------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------------

SLICE = ["repro_torch", "repro_torch.configs", "repro_torch.models.base",
         "repro_torch.models.layers", "repro_torch.models.transformer",
         "repro_torch.models.registry", "repro_torch.kernels.ref",
         "repro_torch.kernels.hier_agg", "repro_torch.kernels.flash_attention",
         "repro_torch.kernels.ssd_scan", "repro_torch.models.mamba2",
         "repro_torch.serving", "repro_torch.serving.engine",
         "repro_torch.launch.serve",
         "repro_torch.kernels.ops", "repro_torch.kernels._build",
         "repro_torch.optim.adamw", "repro_torch.optim.schedules",
         "repro_torch.core.rng", "repro_torch.core.comm",
         "repro_torch.core.compression", "repro_torch.core.tree",
         "repro_torch.serverless.stores", "repro_torch.serverless.worker",
         "repro_torch.data.pipeline", "repro_torch.models.hybrid",
         "repro_torch.models.moe", "repro_torch.launch.mesh",
         "repro_torch.core.hier_sync", "repro_torch.core.elastic",
         "repro_torch.distributed.sharding", "repro_torch.launch.steps",
         "repro_torch.launch.train", "repro_torch.checkpoint.checkpointer",
         "repro_torch.examples.train_e2e", "repro_torch.models.vlm",
         "repro_torch.models.encdec"]


def test_port_loads_neither_jax_nor_the_reference():
    code = ("import importlib, sys\n"
            f"for m in {SLICE!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print('BAD', bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax_or_reference_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default is valid here")
    cfg = reduced(ARCHS["olmo-1b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.params_from_numpy({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.from_numpy({"tokens": np.zeros((2, 3), np.int32)})
    assert T.resolve_device("cpu").type == "cpu"


def test_init_is_seeded_by_its_own_generator():
    cfg = reduced(ARCHS["olmo-1b"])
    torch.manual_seed(123)
    a = registry.init(7, cfg, "cpu")
    torch.manual_seed(456)
    b = registry.init(7, cfg, "cpu")
    c = registry.init(8, cfg, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(b)))
    assert not torch.equal(T.leaves(a)[-1], T.leaves(c)[-1])


@pytest.mark.parametrize("build", ["unflatten", "registry_init"])
def test_trees_free_their_leaves_without_the_garbage_collector(build):
    """Dropping the last reference to a rebuilt tree frees its leaves at
    once: no reference cycle keeps a model's weights or a gradient alive
    until the collector runs (which on the card shows as peak memory)."""
    import gc
    import weakref
    was = gc.isenabled()
    gc.disable()
    try:
        if build == "unflatten":
            like = {"b": {"x": 0, "y": 0}, "a": 0}
            tree = T.unflatten(like, [torch.zeros(3) for _ in range(3)])
        else:
            tree = registry.init(0, reduced(ARCHS["zamba2-7b"]), "cpu")
        refs = [weakref.ref(x) for x in T.leaves(tree)]
        del tree
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        if was:
            gc.enable()
