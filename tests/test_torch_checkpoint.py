"""The port's checkpointer (``checkpoint/checkpointer.py``) against the
reference's: one format (npz + json, "/"-joined keys, bf16 stored as f32,
an optimizer state's ``.step``/``.mu``/``.nu``), so a checkpoint written
by either package restores in the other with equal keys and values. Also
the ports of ``tests/test_substrate.py::test_{disk,store}_checkpoint_
roundtrip`` and ``tests/test_fault_tolerance.py::test_checkpoint_restart_
resumes_training_exactly``."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointMeta as JMeta  # noqa: E402
from repro.checkpoint import DiskCheckpointer as JDisk  # noqa: E402
from repro.checkpoint import StoreCheckpointer as JStoreCk  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.serverless import ObjectStore as JObjectStore  # noqa: E402
from repro_torch.checkpoint import (CheckpointMeta, DiskCheckpointer,  # noqa: E402
                                    StoreCheckpointer)
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import (DataConfig, IteratorState,  # noqa: E402
                              ShardedLoader, TokenDataset)
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import AdamW, AdamWState  # noqa: E402
from repro_torch.serverless import ObjectStore  # noqa: E402


def _tree():
    """tests/test_substrate.py::_tree in the port."""
    return {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _f32(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_disk_checkpoint_roundtrip(tmp_path):
    ck = DiskCheckpointer(str(tmp_path))
    t = _tree()
    ck.save("m", t, CheckpointMeta(step=3, epoch=1, index=42))
    back, meta = ck.restore("m", t)
    assert meta.step == 3 and meta.index == 42
    for a, b in zip(T.leaves(t), T.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_f32(a), _f32(b))


def test_store_checkpoint_roundtrip_and_timing():
    store = ObjectStore()
    ck = StoreCheckpointer(store)
    t = _tree()
    t_up = ck.save("m", t, CheckpointMeta(step=1))
    back, meta, t_down = ck.restore("m", t)
    assert t_up > 0 and t_down > 0
    assert meta.step == 1
    for a, b in zip(T.leaves(t), T.leaves(back)):
        np.testing.assert_array_equal(_f32(a), _f32(b))
    assert store.stats.puts >= 2  # payload + meta were billed


def _both_states():
    """A reduced olmo-1b in bf16 with an optimizer state after two
    updates, in each package (the same numbers)."""
    jcfg = j_reduced(J_ARCHS["olmo-1b"]).replace(dtype=jnp.bfloat16)
    jp = jreg.init(jax.random.key(3), jcfg)
    jopt = JAdamW(lr=1e-2)
    js = jopt.init(jp)
    for _ in range(2):
        g = jax.tree.map(lambda x: jnp.ones_like(x) * 0.01, jp)
        jp, js = jopt.update(g, js, jp)
    tp = registry.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = AdamWState(step=int(js.step),
                    mu=T.from_numpy(jax.tree.map(np.asarray, js.mu), "cpu"),
                    nu=T.from_numpy(jax.tree.map(np.asarray, js.nu), "cpu"))
    return {"p": jp, "o": js}, {"p": tp, "o": ts}


def _npz_keys(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_port_writes_the_reference_keys(tmp_path):
    jtree, ttree = _both_states()
    JDisk(str(tmp_path / "j")).save("c", jtree, JMeta(step=2))
    DiskCheckpointer(str(tmp_path / "t")).save("c", ttree,
                                               CheckpointMeta(step=2))
    a = _npz_keys(tmp_path / "j" / "c.npz")
    b = _npz_keys(tmp_path / "t" / "c.npz")
    assert sorted(a) == sorted(b)
    assert {"o/.step", "o/.mu/blocks/attn/wq", "o/.nu/embed/tok",
            "p/embed/unembed"} <= set(a) and len(a) == 28
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tmp_path / "t" / "c.json") as f, \
            open(tmp_path / "j" / "c.json") as g:
        assert f.read() == g.read()


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _both_states()
    JDisk(str(tmp_path)).save("c", jtree, JMeta(step=2, epoch=1, index=5))
    back, meta = DiskCheckpointer(str(tmp_path)).restore("c", ttree)
    assert (meta.step, meta.epoch, meta.index) == (2, 1, 5)
    assert isinstance(back["o"], AdamWState) and back["o"].step == 2
    for a, b in zip(T.leaves(ttree["p"]) + T.leaves(ttree["o"].mu)
                    + T.leaves(ttree["o"].nu),
                    T.leaves(back["p"]) + T.leaves(back["o"].mu)
                    + T.leaves(back["o"].nu)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_port_checkpoint_restores_in_the_reference():
    jtree, ttree = _both_states()
    store_t = ObjectStore()
    StoreCheckpointer(store_t).save("c", ttree, CheckpointMeta(step=2))
    store_j = JObjectStore()                     # the same bytes, moved
    for k, v in store_t.blobs.items():
        store_j.put(k, v)
    back, meta, t = JStoreCk(store_j).restore("c", jtree)
    assert meta.step == 2 and t > 0
    assert int(back["o"].step) == 2
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_save_copies_the_moments(tmp_path):
    """The port's AdamW updates its moments in place; a saved checkpoint
    keeps the values of the moment it was saved."""
    params = {"w": torch.ones(4)}
    opt = AdamW(lr=0.1)
    state = opt.init(params)
    params, state = opt.update({"w": torch.ones(4)}, state, params)
    store = ObjectStore()
    StoreCheckpointer(store).save("a", {"o": state}, CheckpointMeta())
    saved = state.mu["w"].clone()
    opt.update({"w": torch.ones(4) * 5}, state, params)   # moves mu in place
    back, _, _ = StoreCheckpointer(store).restore("a", {"o": state})
    assert torch.equal(back["o"].mu["w"], saved)
    assert not torch.equal(state.mu["w"], saved)


def test_checkpoint_restart_resumes_training_exactly(tmp_path):
    """The duration-cap path: train, checkpoint, 'die', restore into a
    fresh state, continue == the uninterrupted run (rtol 1e-5)."""
    cfg = reduced(ARCHS["olmo-1b"]).replace(n_layers=1, d_model=64)
    opt = AdamW(lr=1e-2)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16)
    vg = T.value_and_grad(lambda p, b: registry.loss_fn(p, cfg, b))

    def step(params, opt_state, batch):
        loss, g = vg(params, batch)
        params, opt_state = opt.update(g, opt_state, params)
        return params, opt_state, float(loss)

    def fresh():
        params = registry.init(0, cfg, "cpu")
        return params, opt.init(params), ShardedLoader(TokenDataset(data))

    p, o, loader = fresh()
    losses_a = []
    for _ in range(6):
        p, o, loss = step(p, o, T.from_numpy(loader.next_batch(4), "cpu"))
        losses_a.append(loss)

    ck = DiskCheckpointer(str(tmp_path))
    p, o, loader = fresh()
    losses_b = []
    for _ in range(3):
        p, o, loss = step(p, o, T.from_numpy(loader.next_batch(4), "cpu"))
        losses_b.append(loss)
    ck.save("w", {"p": p, "o": o},
            CheckpointMeta(step=3, epoch=loader.state.epoch,
                           index=loader.state.index))
    like_p, like_o, _ = fresh()
    restored, meta = ck.restore("w", {"p": like_p, "o": like_o})
    p2, o2 = restored["p"], restored["o"]
    loader2 = ShardedLoader(TokenDataset(data),
                            IteratorState(meta.epoch, meta.index))
    for _ in range(3):
        p2, o2, loss = step(p2, o2, T.from_numpy(loader2.next_batch(4),
                                                 "cpu"))
        losses_b.append(loss)
    np.testing.assert_allclose(losses_a, losses_b, rtol=1e-5)
    assert os.path.exists(tmp_path / "w.npz")
