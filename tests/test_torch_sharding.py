"""The port's sharding rules (``distributed/sharding.py``) against the
reference's, for all 10 archs: param, batch and cache specs equal the
reference's ``PartitionSpec``s entry for entry, from meta-device shapes
(nothing is allocated, arctic-480b included; the vlm and audio caches are
derived from ``batch_extras``' meta stand-ins). Also the ports of
``tests/test_substrate.py::test_param_specs_divisible`` and
``::test_moe_expert_fallback``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import batch_extras as j_batch_extras  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch.steps import decode_cache_shapes  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import ARCHS, batch_extras  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.distributed import (batch_specs, cache_specs,  # noqa: E402
                                     opt_state_specs, param_specs)
from repro_torch.models import registry  # noqa: E402

PORTED = sorted(a for a, c in ARCHS.items()
                if c.family in ("dense", "moe", "ssm", "hybrid", "vlm",
                                "audio"))


def _jshapes(arch):
    return jax.eval_shape(lambda k: jreg.init(k, J_ARCHS[arch]),
                          jax.random.key(0))


def _specs(tree):
    return [tuple(s) for s in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def test_eight_archs_are_ported():
    assert len(PORTED) == 10


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("kw", [
    dict(model_size=16, fsdp_axis="data", fsdp_divisor=16),
    dict(model_size=16),
    # the hier train step's gradient layouts (launch/steps.py)
    dict(model_size=1, fsdp_axis="data", fsdp_min_size=2 ** 14,
         fsdp_divisor=4),
    dict(model_size=1, fsdp_axis=("pod", "data"), fsdp_min_size=2 ** 14,
         fsdp_divisor=8),
], ids=["model16_fsdp16", "model16", "hier4", "hier1_pod"])
def test_param_specs_equal_reference(arch, kw):
    want = _specs(jsh.param_specs(_jshapes(arch), **kw))
    got = T.leaves(param_specs(registry.init(0, ARCHS[arch], "meta"), **kw))
    assert got == want


@pytest.mark.parametrize("arch", PORTED)
def test_batch_and_cache_specs_equal_reference(arch):
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    for axes, dsize in ((("data",), 16), (("pod", "data"), 32)):
        shapes = {"tokens": jax.ShapeDtypeStruct((32, 64), "int32"),
                  "one": jax.ShapeDtypeStruct((1, 64), "int32")}
        want = _specs(jsh.batch_specs(shapes, axes, data_size=dsize))
        got = T.leaves(batch_specs(
            {k: torch.empty(v.shape, device="meta")
             for k, v in shapes.items()}, axes, data_size=dsize))
        assert got == want
        jcache = decode_cache_shapes(jcfg, 32, 256,
                                     j_batch_extras(jcfg, 32, 256) or None)
        tcache = registry.init_decode_cache(
            registry.init(0, cfg, "meta"), cfg, 32, 256,
            batch_extras(cfg, 32, 256) or None)
        assert [x.shape for x in jax.tree.leaves(jcache)] == \
            [tuple(x.shape) for x in T.leaves(tcache)]
        want = _specs(jsh.cache_specs(jcache, axes, model_size=16,
                                      data_size=dsize))
        got = T.leaves(cache_specs(tcache, axes, model_size=16,
                                   data_size=dsize))
        assert got == want


@pytest.mark.parametrize("arch", PORTED)
def test_param_specs_divisible(arch):
    """Every sharded dim divides the 16-way model axis, for every arch."""
    shapes = registry.init(0, ARCHS[arch], "meta")
    specs = param_specs(shapes, model_size=16, fsdp_axis="data",
                        fsdp_divisor=16)
    n_model_sharded = 0
    for (path, leaf), spec in zip(T.leaves_with_path(shapes),
                                  T.leaves(specs)):
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            assert leaf.shape[dim] % 16 == 0, (path, leaf.shape, spec)
            if ax == "model":
                n_model_sharded += 1
    assert n_model_sharded > 0, "no tensor parallelism found"


def test_moe_expert_fallback():
    """qwen2-moe: 60 experts don't divide 16 -> per-expert FFN TP instead."""
    specs = param_specs(registry.init(0, ARCHS["qwen2-moe-a2.7b"], "meta"),
                        model_size=16)
    assert specs["blocks"]["moe"]["experts"]["wi"] == (None, None, None,
                                                       "model")
    # arctic's 128 experts DO divide 16 -> expert parallel
    specs2 = param_specs(registry.init(0, ARCHS["arctic-480b"], "meta"),
                         model_size=16)
    assert specs2["blocks"]["moe"]["experts"]["wi"] == (None, "model")


def test_opt_state_specs_mirror_params():
    pspecs = param_specs(registry.init(0, ARCHS["olmo-1b"], "meta"),
                         model_size=16)
    o = opt_state_specs(pspecs)
    assert o.step == () and o.mu is pspecs and o.nu is pspecs
