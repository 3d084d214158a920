"""Helpers of the simulator parity tests (tests/test_torch_{platform,events,
scheduler,arrivals,workflow}.py): both packages' numpy layers side by side,
and an exact structural comparison of their results."""
import dataclasses
import importlib
import math
import types

import numpy as np

MODULES = ("core.bayes_opt", "core.comm", "core.constraints",
           "core.cost_model", "core.monitor", "core.probe_cache",
           "core.scheduler", "serverless.arrivals", "serverless.backends",
           "serverless.events", "serverless.platform", "serverless.stores",
           "serverless.worker", "serving.batcher", "workflow.allocator",
           "workflow.dag", "workflow.orchestrator", "workflow.tuner")


def package(name: str) -> types.SimpleNamespace:
    """``name``'s simulator modules by their last name (``pk.events``,
    ``pk.scheduler``, ...); ``name`` is ``repro`` or ``repro_torch``."""
    return types.SimpleNamespace(**{
        m.split(".")[-1]: importlib.import_module(f"{name}.{m}")
        for m in MODULES})


REF, PORT = package("repro"), package("repro_torch")
BOTH = (REF, PORT)


def canon(x):
    """A value both packages' results can be held equal by ``==``:
    dataclasses become (class name, fields...) as ``dataclasses.astuple``
    flattens them, arrays their dtype, shape and bytes, NaN a marker."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            canon(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, canon(v)) for k, v in x.items())
    if isinstance(x, float) and math.isnan(x):
        return ("nan",)
    return x


def same(a, b):
    """Both results equal, exactly."""
    ca, cb = canon(a), canon(b)
    assert ca == cb, (ca, cb)
