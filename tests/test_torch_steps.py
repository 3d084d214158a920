"""The port's step builders and input specs (``launch/steps.py``,
``configs.input_specs``, ``launch/mesh.py::make_production_mesh``) against
the reference's: ``input_specs`` and ``decode_cache_shapes`` for every
(arch, shape) pair, shape for shape and dtype for dtype, with nothing
allocated; ``make_prefill_step`` and ``make_serve_step`` against the
reference's jitted steps on a one-device mesh for the 10 reduced archs,
from the reference's weights, at ``tests/test_arch_smoke.py``'s decode
tolerance (rtol 2e-2, atol 2e-3), with and without ZeRO-3 parameters."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import input_specs as j_input_specs  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.configs import reduced_batch as j_reduced_batch  # noqa: E402
from repro.launch.mesh import make_custom_mesh as j_mesh  # noqa: E402
from repro.launch.steps import decode_cache_shapes as j_cache_shapes  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill_step  # noqa: E402
from repro.launch.steps import make_serve_step as j_serve_step  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro_torch.configs import ARCHS, input_specs, pairs, reduced  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.launch.mesh import (axis_size, make_custom_mesh,  # noqa: E402
                                     make_production_mesh, process_group)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.steps import (decode_cache_shapes,  # noqa: E402
                                      make_prefill_step, make_serve_step)
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.base import INPUT_SHAPES  # noqa: E402

PAIRS = list(pairs())
RTOL, ATOL = 2e-2, 2e-3          # tests/test_arch_smoke.py's decode check
B, S, NEW = 2, 32, 4


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _same_shapes(got, want):
    """A tree of the port's meta tensors against the reference's
    ShapeDtypeStructs: the same paths, shapes and dtypes."""
    g = T.leaves_with_path(got)
    w = [("/".join(str(k.key) for k in path), x)
         for path, x in jax.tree_util.tree_leaves_with_path(want)]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape), path
        assert _dtype_name(a) == str(b.dtype), path
        assert a.device.type == "meta", path


@pytest.mark.parametrize("arch_id,shape_name", PAIRS)
def test_input_specs_match_reference(arch_id, shape_name):
    """tests/test_configs.py::test_input_specs_build's checks, and the
    reference's shapes and dtypes, as meta tensors."""
    cfg, shape = ARCHS[arch_id], INPUT_SHAPES[shape_name]
    specs = input_specs(cfg, shape)
    assert "tokens" in specs
    if shape.kind == "train":
        assert specs["tokens"].shape == (shape.global_batch, shape.seq_len)
    if shape.kind == "decode":
        assert specs["tokens"].shape == (shape.global_batch, 1)
        assert specs["pos"].shape == ()
    if cfg.family == "vlm":
        assert specs["image_embeds"].shape[1:] == (cfg.n_image_tokens,
                                                   cfg.d_vision)
    if cfg.family == "audio":
        assert specs["audio_frames"].shape[2] == cfg.d_audio
    _same_shapes(specs, j_input_specs(J_ARCHS[arch_id], J_SHAPES[shape_name]))


@pytest.mark.parametrize("arch_id,shape_name", PAIRS)
def test_decode_cache_shapes_match_reference(arch_id, shape_name):
    """The decode cache at each pair's batch and length, from meta
    parameters: the reference's shapes and dtypes, nothing allocated."""
    shape = INPUT_SHAPES[shape_name]
    specs = input_specs(ARCHS[arch_id], shape)
    extras = {k: v for k, v in specs.items() if k not in ("tokens", "pos",
                                                          "labels")}
    got = decode_cache_shapes(ARCHS[arch_id], shape.global_batch,
                              shape.seq_len, extras or None)
    jspecs = j_input_specs(J_ARCHS[arch_id], J_SHAPES[shape_name])
    jextras = {k: v for k, v in jspecs.items() if k not in ("tokens", "pos",
                                                            "labels")}
    want = j_cache_shapes(J_ARCHS[arch_id], shape.global_batch,
                          shape.seq_len, extras_shapes=jextras or None)
    _same_shapes(got, want)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's reduced weights, batch, and its jitted prefill and
    serve steps' results: prefill of the prompt, then one serve step at
    position S against a prefill cache of S + NEW."""
    jcfg = j_reduced(J_ARCHS[arch])
    jparams = jreg.init(jax.random.key(0), jcfg)
    batch = {k: np.asarray(v) for k, v in j_reduced_batch(jcfg, B, S).items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    mesh = j_mesh("1x1")
    prefill, _, _ = j_prefill_step(jcfg, mesh)
    logits, cache = prefill(jparams, jbatch)
    _, long_cache = jreg.prefill(jparams, jcfg, jbatch, max_seq=S + NEW)
    serve, _, _, _ = j_serve_step(jcfg, mesh)
    tok = jnp.asarray(batch["tokens"][:, -1:])
    dlogits, dcache = serve(jparams, long_cache, jnp.int32(S), tok)
    np_ = functools.partial(jax.tree.map, np.asarray)
    return dict(params=np_(jparams), batch=batch,
                prefill=(np_(logits), np_(cache)),
                serve=(np_(dlogits), np_(dcache)))


def _close(got, want, what):
    """(logits, cache) against the reference's, leaf for leaf."""
    gl = T.leaves(T.to_numpy(dict(zip("lc", got))))
    wl = jax.tree.leaves(dict(zip("lc", want)))
    assert len(gl) == len(wl), what
    for a, b in zip(gl, wl):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_serve_steps_match_reference(arch, fsdp, monkeypatch):
    monkeypatch.setattr(steps, "FSDP_MIN_SIZE", 2 ** 12)  # split the leaves
    ref = _reference(arch)
    cfg = reduced(ARCHS[arch])
    full = registry.params_from_numpy(ref["params"], "cpu")
    batch = T.from_numpy({k: v for k, v in ref["batch"].items()
                          if k != "labels"}, "cpu")
    with process_group("cpu"):
        mesh = make_custom_mesh("1x1", "cpu")
        prefill = make_prefill_step(cfg, mesh, fsdp=fsdp)
        serve = make_serve_step(cfg, mesh, fsdp=fsdp)
        if fsdp:
            assert any(z is not None for z in prefill.fsdp)
        params = prefill.shard_params(full)
        logits, cache = prefill(params, prefill.local_batch(batch))
        _close((logits, cache), ref["prefill"], f"{arch} prefill")
        _, long_cache = prefill(params, batch, max_seq=S + NEW)
        tok = batch["tokens"][:, -1:]
        got = serve(params, long_cache, S, tok)
    _close(got, ref["serve"], f"{arch} serve")


def test_local_batch_splits_rows_or_keeps_the_batch():
    """batch_specs' rule: rows split over the data ranks when the batch
    divides, the whole batch (and a 0-dim pos) otherwise."""
    with fake_world(8):
        mesh = make_custom_mesh("2x4x1", "cpu")
        step = make_prefill_step(reduced(ARCHS["olmo-1b"]), mesh)
        specs = input_specs(ARCHS["olmo-1b"], INPUT_SHAPES["train_4k"])
        assert step.local_batch(specs)["tokens"].shape == (32, 4096)
        specs = input_specs(ARCHS["olmo-1b"], INPUT_SHAPES["long_500k"])
        local = step.local_batch(specs)
        assert local["tokens"].shape == (1, 1) and local["pos"].shape == ()


@pytest.mark.parametrize("multi_pod,dims", [(False, {"data": 256}),
                                            (True, {"pod": 2, "data": 256})])
def test_production_mesh(multi_pod, dims):
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert mesh.mesh_dim_names == tuple(dims) + ("model",)
        for name, n in dict(dims, model=1).items():
            assert axis_size(mesh, name) == n
