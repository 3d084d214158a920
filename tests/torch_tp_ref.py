"""The reference's side of the tensor-parallel tests
(``test_torch_tp_world2.py``, ``test_torch_tp_world4.py``): for a case of
``torch_dist_checks.TP_CASES``, the JAX package's init(key 0) of the
reduced config, written where the ranks read it, and its one-device
logits, loss and gradients on ``configs.reduced_batch``."""
import functools
import os

import jax
import numpy as np

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import registry as jreg
from repro_torch.configs import reduced_batch
from repro_torch.core import tree as T

import torch_dist_checks as dc

# the port's parity tolerances (tests/test_torch_models.py,
# tests/test_torch_moe.py: tests/test_kernel_integration.py's)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5
LOGITS_RTOL, LOGITS_ATOL = 1e-4, 5e-5


# the vlm cases' cross gates, opened on both sides: closed (0 at init)
# they would hide a broken cross layer (tests/test_torch_vlm.py's)
GATE = 0.5


def _program(case):
    """(arch, the overrides) of ``case``'s one-device program: without
    ``seq_shard``, whose constraint has no mesh to name on one device and
    changes no number, and without ``nope``, which the reference does not
    have (such a case takes its init alone: it does not change the
    init)."""
    arch, over = dc.TP_CASES[case]
    return arch, tuple(sorted((k, v) for k, v in over.items()
                              if k not in ("seq_shard", "nope")))


def jax_config(case):
    arch, over = _program(case)
    return j_reduced(J_ARCHS[arch]).replace(**dict(over))


def reference(case):
    """{"init", "loss", "logits", "grads"} of ``case`` on one device, as
    numpy (init and grads keyed by leaf path)."""
    return _reference(*_program(case))


@functools.lru_cache(maxsize=None)
def _reference(arch, over):
    cfg = j_reduced(J_ARCHS[arch]).replace(**dict(over))
    params = jreg.init(jax.random.key(0), cfg)
    if cfg.family == "vlm":
        params["cross"] = dict(params["cross"], **{
            g: jax.numpy.full_like(params["cross"][g], GATE)
            for g in ("gate_attn", "gate_mlp")})
    batch = reduced_batch(cfg, dc.TP_BATCH, dc.TP_SEQ)
    loss, grads = jax.value_and_grad(
        lambda p: jreg.loss_fn(p, cfg, batch))(params)
    logits, _ = jreg.prefill(params, cfg, batch)
    npy = lambda t: dict(T.leaves_with_path(  # noqa: E731
        jax.tree.map(np.asarray, t)))
    return {"init": npy(params), "loss": float(loss),
            "logits": np.asarray(logits), "grads": npy(grads)}


def write_inits(workdir, cases):
    for case in cases:
        np.savez(os.path.join(workdir,
                              f"init_{case.replace('/', '_')}.npz"),
                 **reference(case)["init"])


def check_case(res, key, case):
    """One rank's ``_tp_forward`` results under ``key`` against the
    reference's: logits of its rows, the loss, every whole gradient."""
    want = reference(case)
    lo, n = res[f"{key}/rows"]
    np.testing.assert_allclose(res[f"{key}/logits"],
                               want["logits"][lo:lo + n], rtol=LOGITS_RTOL,
                               atol=LOGITS_ATOL, err_msg=f"{key} logits")
    np.testing.assert_allclose(float(res[f"{key}/loss"]), want["loss"],
                               rtol=LOSS_RTOL, err_msg=f"{key} loss")
    pre = f"{key}/grads/"
    got = {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}
    assert sorted(got) == sorted(want["grads"])
    for path, g in got.items():
        np.testing.assert_allclose(g, want["grads"][path], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL,
                                   err_msg=f"{key} grad {path}")
    assert int(res[f"{key}/n_split"]) > 0      # the model split some leaves
