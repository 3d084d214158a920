"""Parameter / activation / cache sharding rules (port of the JAX package's
``distributed/sharding.py``).

Rules are path+shape driven and uniform across the model zoo:

 - tensor parallelism over the ``model`` axis: attention head dims, FFN
   hidden dims, MoE expert axis (expert parallelism), SSM head/inner dims,
   vocab dim of embed/unembed;
 - batch over ``data`` (x ``pod`` on a multi-pod mesh);
 - optional FSDP (ZeRO-style) over ``data`` for weight storage, used by
   the ``hier`` training strategy for its gradient shards and optimizer
   state (``launch/steps.py``).

Each rule lists candidate dim assignments in preference order; the first
whose dims all divide evenly by the mesh axis wins (qwen2-moe's 60 experts
don't divide a 16-way model axis, so expert parallelism falls back to
per-expert FFN tensor parallelism). Stacked-layer leaves (under
blocks/encoder/decoder/cross) keep their leading layer axis unsharded.

A spec is a tuple with one entry per dim (an axis name, a tuple of axis
names, or None), trailing Nones trimmed: the entries of the reference's
``PartitionSpec``. The rules read only shapes, so a tree of meta tensors
(``registry.init(0, cfg, device="meta")``) is enough for any arch.
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np

from repro_torch.core import tree as T

# path-regex -> list of candidate {dim-from-right: axis} assignments
_RULES = [
    (r"embed/tok$",        [{-2: "model"}, {-1: "model"}]),   # (V, d)
    (r"embed/unembed$",    [{-1: "model"}]),                  # (d, V)
    (r"attn/w[qkv]$|self_attn/w[qkv]$|cross_attn/w[qkv]$", [{-1: "model"}]),
    (r"attn/wo$|self_attn/wo$|cross_attn/wo$", [{-2: "model"}]),
    (r"attn/b[qkv]$",      [{-1: "model"}]),
    (r"mlp/wi$|mlp/wg$|shared/wi$|shared/wg$|dense/wi$|dense/wg$",
                           [{-1: "model"}]),
    (r"mlp/wo$|shared/wo$|dense/wo$", [{-2: "model"}]),
    # MoE: expert parallel if E divides, else per-expert tensor parallel
    (r"experts/wi$|experts/wg$", [{-3: "model"}, {-1: "model"}]),
    (r"experts/wo$",       [{-3: "model"}, {-2: "model"}]),
    (r"router$",           [{}]),
    (r"/wz$|/wx$",         [{-1: "model"}]),          # (d, d_inner)
    (r"/wdt$",             [{-1: "model"}]),          # (d, nh)
    (r"/wB$|/wC$",         [{}]),                     # small, replicated
    (r"dt_bias$|A_log$|/D$", [{-1: "model"}]),        # (nh,)
    (r"conv_x$",           [{-1: "model"}]),          # (W, d_inner)
    (r"conv_BC$",          [{}]),
    (r"gate_ln/scale$",    [{-1: "model"}]),          # (d_inner,)
    (r"blocks/wo$",        [{-2: "model"}]),          # mamba out proj
    (r"vision_proj$|audio_proj$", [{}]),
]

_STACKED = re.compile(r"^(blocks|encoder|decoder|cross)/")


def _map_with_path(fn, tree):
    """``fn(path, leaf)`` over a tree, keeping its dict structure."""
    flat = T.leaves_with_path(tree)
    return T.unflatten(tree, [fn(p, x) for p, x in flat])


def _assign(path: str, shape, model_size: int):
    """Pick the first candidate assignment whose dims divide evenly."""
    ndim = len(shape)
    stacked = bool(_STACKED.match(path))
    for pat, cands in _RULES:
        if re.search(pat, path):
            for cand in cands:
                ok = True
                for off, _ax in cand.items():
                    i = ndim + off
                    if i < 0 or (stacked and i == 0) \
                            or shape[i] % model_size != 0:
                        ok = False
                        break
                if ok:
                    return cand, stacked
            return {}, stacked
    return {}, stacked


def _entry(axes):
    """A spec entry for mesh axes: a one-axis tuple is its name, as
    ``PartitionSpec`` normalizes it."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _trim(entries) -> tuple:
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _leaf_spec(path: str, shape, *, model_size: int,
               fsdp_axis=None, fsdp_min_size: int = 0,
               fsdp_divisor: int = 1) -> tuple:
    ndim = len(shape)
    dims, stacked = _assign(path, shape, model_size)
    entries = [None] * ndim
    for off, ax in dims.items():
        entries[ndim + off] = ax
    size = int(np.prod(shape)) if shape else 1
    if fsdp_axis and size >= fsdp_min_size:
        cands = [i for i in range(1 if stacked else 0, ndim)
                 if entries[i] is None and shape[i] % fsdp_divisor == 0
                 and shape[i] >= fsdp_divisor]
        if cands:
            i = max(cands, key=lambda i: shape[i])
            entries[i] = _entry(fsdp_axis)
    return _trim(entries)


def param_specs(params_shapes, *, model_size: int = 1,
                fsdp_axis=None, fsdp_min_size: int = 2 ** 20,
                fsdp_divisor: int = 1):
    """A tree of specs mirroring ``params_shapes`` (leaves with a
    ``.shape``: tensors, meta tensors)."""
    return _map_with_path(
        lambda path, leaf: _leaf_spec(
            path, tuple(leaf.shape), model_size=model_size,
            fsdp_axis=fsdp_axis, fsdp_min_size=fsdp_min_size,
            fsdp_divisor=fsdp_divisor), params_shapes)


def batch_specs(batch_shapes, data_axes, *, data_size: int = 1):
    """Shard dim 0 (global batch) of every input over the data(-like) axes.
    Batches that don't divide (e.g. long_500k's batch=1) stay replicated."""
    return T.tree_map(
        lambda x: (_entry(data_axes),) if len(x.shape)
        and x.shape[0] % data_size == 0 else (), batch_shapes)


# second entry in the "model" tuple is the fallback dim when the first
# doesn't divide the axis (e.g. kv=8 heads on a 16-way model axis -> shard
# the 128-wide head_dim instead)
_CACHE_RULES = [
    (r"(^|/)[kv]$", {1: ("data",), -2: ("model", -1)}),  # (L, b, s, kv, hd)
    (r"ssm$",    {1: ("data",), 2: ("model", 3)}),       # (L, b, nh, n, p)
    (r"conv_x$", {1: ("data",), -1: ("model",)}),        # (L, b, W-1, d_in)
    (r"conv_BC$", {1: ("data",)}),
]


def cache_specs(cache_shapes, data_axes, *, model_size: int = 1,
                data_size: int = 1):
    """KV/SSM cache specs: batch over data, heads/channels over model.
    Axes that don't divide evenly are left replicated."""

    def f(p, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        entries = [None] * ndim
        for pat, rule in _CACHE_RULES:
            if re.search(pat, p):
                for d, spec in rule.items():
                    idx = d if d >= 0 else ndim + d
                    if spec[0] == "data":
                        if shape[idx] % data_size == 0:
                            entries[idx] = _entry(data_axes)
                        continue
                    # "model" with optional fallback dim
                    cands = [idx] + [c if c >= 0 else ndim + c
                                     for c in spec[1:]]
                    for c in cands:
                        if entries[c] is None and shape[c] % model_size == 0:
                            entries[c] = "model"
                            break
                break
        else:
            if ndim >= 2 and shape[1] % data_size == 0:
                entries[1] = _entry(data_axes)
        return _trim(entries)

    return _map_with_path(f, cache_shapes)


def opt_state_specs(pspecs):
    """Optimizer-state specs mirror the parameter specs leaf-for-leaf."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=(), mu=pspecs, nu=pspecs)


def placement(spec: tuple, model_size: int = 1) -> Optional[tuple]:
    """What a spec asks of the port's one-process-per-rank step:
    ``(dim, axes)`` to shard dim ``dim`` over the mesh axes ``axes`` (a
    name or a tuple of names), or None to replicate. "model" entries
    replicate on a model axis of size 1; a larger one raises."""
    names = [ax if isinstance(ax, tuple) else (ax,) for ax in spec]
    if model_size != 1 and any("model" in n for n in names):
        raise NotImplementedError(
            "a model axis > 1 (tensor parallelism) is not ported yet "
            "(ROADMAP A16)")
    for i, (ax, n) in enumerate(zip(spec, names)):
        if ax is not None and "model" not in n:
            return i, ax
    return None
