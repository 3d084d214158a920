"""Nested-dict parameter trees (dicts of dicts of tensors): the port's
stand-in for JAX pytrees.

Leaves are visited in ``jax.tree.leaves`` order (dict keys sorted at every
level), so a flat gradient holds the same parameters at the same offsets in
both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Asking for CUDA on a machine
    without it raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run on the CPU")
    return dev


def leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``leaves`` order; a path joins the dict keys
    from the root with "/", as the reference's checkpointer and sharding
    rules name a leaf ("blocks/attn/wq")."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_path(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def unflatten(like, flat_leaves: List[Any]):
    """Rebuild ``like``'s structure from leaves in ``leaves`` order. (No
    recursive closure: one would form a reference cycle holding every
    leaf until the garbage collector runs.)"""
    return _build(like, iter(flat_leaves))


def _build(like, it):
    if isinstance(like, dict):
        return {k: _build(like[k], it) for k in sorted(like)}
    return next(it)


def from_numpy(tree, device="cuda"):
    """A tree of numpy arrays -> the same tree of tensors on ``device``.
    bf16 arrays (``ml_dtypes.bfloat16``, what ``np.asarray`` gives for a
    JAX bf16 array) keep their bits."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.array(a).view(np.uint16))
            return t.view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)
    return tree_map(conv, tree)


def to_numpy(tree):
    """A tree of tensors -> numpy arrays on the host (bf16 as float32)."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(conv, tree)


def value_and_grad(fn: Callable) -> Callable:
    """``fn(params, *args) -> scalar`` becomes ``f(params, *args) ->
    (value, grads)``, grads a tree like ``params`` (``jax.value_and_grad``),
    from one forward. The leaves are aliased, not copied."""
    def f(params, *args):
        with torch.enable_grad():
            p = tree_map(lambda x: x.detach().requires_grad_(True), params)
            ls = leaves(p)
            value = fn(p, *args)
            gs = torch.autograd.grad(value, ls, allow_unused=True)
        return value.detach(), unflatten(
            params, [torch.zeros_like(x) if g is None else g
                     for x, g in zip(ls, gs)])
    return f


def grad(fn: Callable) -> Callable:
    """``fn(params, *args) -> scalar`` becomes ``f(params, *args) ->
    grads`` (``jax.grad``)."""
    vg = value_and_grad(fn)
    return lambda params, *args: vg(params, *args)[1]
