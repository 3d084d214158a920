"""The port's collectives (``core/hier_sync.py``, ``core/elastic.py``)
against the reference: the four checks of ``tests/spmd_checks.py`` on 8
gloo ranks (``tests/torch_dist_checks.py`` suite_hier_sync, one spawn for
the file under a hard deadline), at the reference's tolerances. The
gradients are held against the reference's full-batch
``jax.value_and_grad``, computed here."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.core.hier_sync import (STRATEGIES, make_sync_grad_fn,  # noqa: E402
                                        sync_grads)
from repro_torch.launch.mesh import process_group  # noqa: E402
from repro_torch.launch.train import make_local_mesh  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as dc  # noqa: E402

WORLD = 8


def _jloss(params, batch):
    pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return jnp.mean((pred - batch["y"]) ** 2)


@pytest.fixture(scope="module")
def ref():
    params, batch = dc.make_problem()
    loss, grads = jax.value_and_grad(_jloss)(params, batch)
    # the reference's single-device AdamW loop (spmd_checks.check_elastic)
    opt = JAdamW(lr=0.05, weight_decay=0.0, grad_clip=0.0)
    p, s, losses = params, opt.init(params), []
    for _ in range(6):
        l, g = jax.value_and_grad(_jloss)(p, batch)
        p, s = opt.update(g, s, p)
        losses.append(float(l))
    return dict(loss=float(loss), grads={k: np.asarray(v)
                                         for k, v in grads.items()},
                adamw=np.array(losses))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("hier_sync8"))
    dc.run_world("hier_sync", WORLD, work, timeout=240)
    return [dc.load(work, f"hier_sync_rank{r}") for r in range(WORLD)]


@pytest.mark.parametrize("mesh,strategy", [
    ("pod2_data4", "allreduce"), ("pod2_data4", "hier"), ("pod2_data4", "ps"),
    ("pod2_data4", "hier2"), ("data8", "allreduce"), ("data8", "hier"),
    ("data8", "ps")])
def test_sync_equivalence_8ranks(ranks, ref, mesh, strategy):
    """check_sync_equivalence: every strategy == the full-batch gradient,
    on every rank (loss rtol 1e-5, grads rtol 1e-4 / atol 1e-5)."""
    for r in ranks:
        np.testing.assert_allclose(r[f"{mesh}/{strategy}/loss"], ref["loss"],
                                   rtol=1e-5)
        for k, want in ref["grads"].items():
            np.testing.assert_allclose(r[f"{mesh}/{strategy}/{k}"], want,
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("trial", range(5))
def test_sync_property_8ranks(ranks, trial):
    """check_sync_property: ``hier`` is an exact mean for leaf sizes that do
    not divide 8 (the padding path), rtol 1e-5 / atol 1e-6."""
    for rank, r in enumerate(ranks):
        keys = [k for k in r if k.startswith(f"property/{trial}/")
                and not k.endswith("/input")]
        assert len(keys) == 4
        for k in keys:
            x = r[k + "/input"]
            want = x.mean(0, keepdims=True)
            np.testing.assert_allclose(r[k], want, rtol=1e-5, atol=1e-6)


def test_hier2_q_8ranks(ranks, ref):
    """check_hier2_q: the bf16 cross-pod hop within bf16 error of exact."""
    for r in ranks:
        np.testing.assert_allclose(r["pod2_data4/hier2_q/loss"], ref["loss"],
                                   rtol=1e-5)
        for k, want in ref["grads"].items():
            np.testing.assert_allclose(r[f"pod2_data4/hier2_q/{k}"], want,
                                       rtol=1e-2, atol=1e-3)


def test_elastic_rescale_8ranks(ranks, ref):
    """check_elastic: a fleet of [4, 4, 8, 8, 2, 8] trains exactly as a
    fixed 8 (rtol 1e-5), ranks joining on a scale-up take rank 0's state,
    and the fixed-8 path equals the reference's single-device AdamW loop
    (rtol 1e-5)."""
    r0 = ranks[0]
    a, b = r0["elastic/rescaled"], r0["elastic/fixed8"]
    np.testing.assert_allclose(a, b, rtol=1e-5)
    assert a[-1] < a[0], "loss must decrease"
    np.testing.assert_allclose(b, ref["adamw"], rtol=1e-5)
    assert r0["elastic/events"].tolist() == [[4, 8], [8, 2], [2, 8]]
    # rank 7 sat out the 4- and 2-worker steps and rejoined each time
    r7 = ranks[7]["elastic/rescaled"]
    assert np.isnan(r7[[0, 1, 4]]).all()
    np.testing.assert_allclose(r7[[2, 3, 5]], a[[2, 3, 5]], rtol=1e-6)


def test_strategy_asserts_as_the_reference():
    for strat in ("hier2", "hier2_q"):
        with pytest.raises(AssertionError, match="pod axis"):
            sync_grads({}, strat, n_data=4, n_pod=1)
    with pytest.raises(ValueError, match="unknown strategy"):
        sync_grads({}, "ring", n_data=4)
    assert STRATEGIES == ("allreduce", "hier", "hier2", "hier2_q", "ps")


@pytest.mark.parametrize("strategy", ["allreduce", "hier", "ps"])
def test_sync_grad_fn_one_rank(ref, strategy):
    """At world size 1 the collectives run on one rank and change
    nothing: the full-batch loss and gradient."""
    params, batch = dc.make_problem()
    with process_group("cpu"):
        f = make_sync_grad_fn(dc.toy_loss, make_local_mesh("cpu"), strategy)
        loss, grads = f(T.from_numpy(params, "cpu"), T.from_numpy(batch, "cpu"))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=1e-4,
                                   atol=1e-5)
