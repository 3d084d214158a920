"""The port's training path (``launch/steps.py::make_train_step``,
``launch/train.py::train``, ``examples/train_e2e.py``) against the
reference on reduced olmo-1b, from the reference's weights: the loss curve
of the reference's ``train()`` (40 steps, batch 8, seq 128, ``hier``, seed
0) at rtol 1e-4, at world size 1 in this process and on 4 gloo ranks
(``tests/torch_dist_checks.py``, one spawn for the file under a hard
deadline), for each strategy; the moments and params after 10 steps at
the reference's gradient tolerances (rtol 5e-4 / atol 1e-5, scaled by
the moments' own size); each rank's moments only for its shard.

The port's loss is the mean of the ranks' losses, the reference's the
global batch's mean: equal here, where the slices are equal and no label
is masked. On one device the reference's strategies compute the same
step, so each of the port's is held to the same curve."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointMeta  # noqa: E402
from repro.checkpoint import DiskCheckpointer as JDisk  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import ShardedLoader as JLoader  # noqa: E402
from repro.data import TokenDataset as JDataset  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.steps import make_train_step as j_make_step  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import DataConfig, ShardedLoader, TokenDataset  # noqa: E402
from repro_torch.distributed import placement  # noqa: E402
from repro_torch.examples import train_e2e  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import process_group  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as dc  # noqa: E402

STEPS, BATCH, SEQ = dc.TRAIN_STEPS, dc.TRAIN_BATCH, dc.TRAIN_SEQ
SHORT = 10                  # steps of the moment checks
CURVE_RTOL = 1e-4


def _numpy(tree):
    return [np.array(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def ref():
    """The reference: its train() curve, and the params and moments after
    SHORT steps of the same run through its make_train_step."""
    cfg = j_reduced(J_ARCHS["olmo-1b"])
    init = jreg.init(jax.random.key(0), cfg)
    init_np = jax.tree.map(np.array, init)
    _, curve = jtrain.train(cfg, steps=STEPS, batch=BATCH, seq=SEQ,
                            strategy="hier", log_every=STEPS)
    opt = JAdamW(lr=3e-4, schedule=j_warmup_cosine(2, STEPS))
    step, pshard, oshard, _ = j_make_step(cfg, jtrain.make_local_mesh(),
                                          strategy="hier", optimizer=opt)
    params = jax.device_put(init, pshard)
    state = jax.device_put(opt.init(params), oshard)
    loader = JLoader(JDataset(JDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ)))
    for _ in range(SHORT):
        b = {k: jnp.asarray(v) for k, v in loader.next_batch(BATCH).items()}
        params, state, _ = step(params, state, b)
    return dict(init=init_np, curve=np.array(curve), params=_numpy(params),
                mu=_numpy(state.mu), nu=_numpy(state.nu))


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """Each of 4 gloo ranks' results (tests/torch_dist_checks.py
    suite_train)."""
    work = str(tmp_path_factory.mktemp("train4"))
    JDisk(work).save("ref_init", {"p": ref["init"]}, CheckpointMeta())
    dc.run_world("train", 4, work, timeout=300)
    return [dc.load(work, f"train_rank{r}") for r in range(4)]


def _batch(cfg, n=4, seq=32):
    return ShardedLoader(TokenDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq))).next_batch(n)


def _carry(ref):
    return registry.params_from_numpy(ref["init"], "cpu")


def _leaves(res, key, name):
    pre = f"{key}/{name}/"
    return [res[k] for k in sorted(k for k in res if k.startswith(pre))]


def _close_to_ref(got, want, what):
    """rtol 5e-4 and an atol of 1e-5 times the reference leaf's largest
    magnitude (the moments are far smaller than gradients)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=5e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=what)


def test_train_world1_matches_reference_curve(ref):
    _, losses, step_s = ttrain.train(
        reduced(ARCHS["olmo-1b"]), steps=STEPS, batch=BATCH, seq=SEQ,
        strategy="hier", params=_carry(ref), device="cpu", log_every=STEPS)
    np.testing.assert_allclose(losses, ref["curve"], rtol=CURVE_RTOL)
    assert len(step_s) == STEPS and min(step_s) > 0


@pytest.mark.parametrize("strategy", ["hier", "hier1", "allreduce"])
def test_train_gloo4_matches_reference_curve(ranks, ref, strategy):
    for r in ranks:
        np.testing.assert_allclose(r[f"curve/{strategy}"], ref["curve"],
                                   rtol=CURVE_RTOL)


def test_hier_gloo4_moments_and_params_match_reference(ranks, ref):
    for r in ranks:
        _close_to_ref(_leaves(r, "data4/hier", "full_mu"), ref["mu"], "mu")
        _close_to_ref(_leaves(r, "data4/hier", "full_nu"), ref["nu"], "nu")
        _close_to_ref(_leaves(r, "data4/hier", "params"), ref["params"],
                      "params")


def test_clip_by_shard_norm_would_fail(ranks, ref):
    """The same 10 steps with each rank clipping by its own shard's norm
    (the optimizer's group sum dropped) miss the reference's moments: the
    gradient norm of reduced olmo-1b is ~4.6 at the start, so the clip
    bites."""
    for r in ranks:
        with pytest.raises(AssertionError):
            _close_to_ref(_leaves(r, "data4/hier_shard_norm", "full_mu"),
                          ref["mu"], "mu")


@pytest.mark.parametrize("strategy,n", [("hier", 2), ("hier1", 4)])
def test_pod_mesh_state_holds_only_the_shard(ranks, ref, strategy, n):
    """(pod 2, data 2): ``hier`` splits the moments over data (2 parts),
    ``hier1`` over pod x data (4); each rank's part is its own slice of
    the gathered state, and the curve and moments match the reference."""
    full_shapes = [x.shape for x in ref["mu"]]
    key = f"pod/{strategy}"
    split = 0
    for idx, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"{key}/curve"], ref["curve"][:SHORT],
                                   rtol=CURVE_RTOL)
        full = _leaves(r, key, "full_mu")
        _close_to_ref(full, ref["mu"], "mu")
        part_i = idx % 2 if strategy == "hier" else idx   # data coordinate
        for mine, whole, shape in zip(_leaves(r, key, "mu"), full,
                                      full_shapes):
            if mine.shape == shape:
                np.testing.assert_array_equal(mine, whole)
                continue
            dims = [d for d in range(len(shape)) if mine.shape[d] != shape[d]]
            assert len(dims) == 1 and mine.shape[dims[0]] * n == shape[dims[0]]
            k = mine.shape[dims[0]]
            np.testing.assert_array_equal(
                mine, np.take(whole, range(part_i * k, (part_i + 1) * k),
                              axis=dims[0]))
            split += 1
    assert split >= 4 * 5      # the large leaves are split on every rank


def test_hier_step_world1_equals_loss_and_adamw():
    """One ``hier`` step at world size 1 (the collectives run, on one
    rank) == registry.loss_fn and AdamW.update called directly."""
    cfg = reduced(ARCHS["olmo-1b"])
    params = registry.init(0, cfg, "cpu")
    batch = T.from_numpy(_batch(cfg), "cpu")
    opt = AdamW(lr=1e-2)
    loss0, grads = T.value_and_grad(
        lambda p, b: registry.loss_fn(p, cfg, b))(params, batch)
    want, _ = opt.update(grads, opt.init(params), params)
    with process_group("cpu"):
        step = make_train_step(cfg, ttrain.make_local_mesh("cpu"),
                               strategy="hier", optimizer=opt)
        got, state, loss = step(params, step.init_opt_state(params), batch)
    assert float(loss) == pytest.approx(float(loss0), rel=1e-6)
    assert state.step == 1
    for a, b in zip(T.leaves(got), T.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_unported_options_raise():
    cfg = reduced(ARCHS["olmo-1b"])
    with process_group("cpu"):
        mesh = ttrain.make_local_mesh("cpu")
        with pytest.raises(NotImplementedError, match="fsdp"):
            make_train_step(cfg, mesh, fsdp=True)
        with pytest.raises(ValueError, match="strategy"):
            make_train_step(cfg, mesh, strategy="ps")
    with pytest.raises(NotImplementedError, match="model axis"):
        placement(("data", "model"), model_size=2)
    assert placement((None, "model", "data"), model_size=1) == (2, "data")
    assert placement(("model",), model_size=1) is None


def test_train_cli_on_cpu(capsys):
    ttrain.main(["--arch", "olmo-1b", "--reduced", "--steps", "3",
                 "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final loss" in out and "step     2" in out


def test_train_e2e_example_on_cpu(capsys):
    """The example end to end at a small size: the batch doubles, the
    checkpoint cycle restores the state bit for bit (it raises if not),
    and the loss falls by the example's own margin (it asserts that)."""
    losses = train_e2e.main(["--steps", "60", "--model-dim", "128",
                             "--layers", "2", "--vocab", "512", "--seq", "64",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 60 and all(np.isfinite(losses))
    assert "batch 8 -> 16" in out and "state bit-equal" in out
