"""Checkpointing: the mechanism behind SMLT's duration-cap restarts and
fault tolerance (paper Section 4.1); port of the JAX package's
``checkpoint/checkpointer.py``, in its format.

Two backends share one format:
 - ``DiskCheckpointer``: npz files on local disk (real training runs);
 - ``StoreCheckpointer``: blobs in the simulated object store (so the
   serverless scheduler's restart path moves the same bytes the paper's
   workers would).

A checkpoint = flat {path: array} + metadata (step, epoch, iterator
state), so restore works across fleet sizes. A path joins the keys from
the root with "/" as the reference's ``_flatten`` does; an ``AdamWState``
contributes ``.step`` (int32), ``.mu`` and ``.nu``, the names the
reference's NamedTuple fields take, so ``{"p": params, "o": opt_state}``
is written as ``p/...``, ``o/.mu/...``, ``o/.nu/...``, ``o/.step`` by
either package and restores in the other. bf16 leaves are stored as f32
(npz has no bf16) and cast back on restore.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState

_STATE_FIELDS = ("step", "mu", "nu")     # the reference's field order


def _walk(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts, ``AdamWState``s, tensors and
    ints, in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, AdamWState):
        for name in _STATE_FIELDS:
            yield from _walk(getattr(tree, name), f"{prefix}.{name}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()   # a copy: the moments change in place
    return np.asarray(leaf, np.int32)   # AdamWState.step


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(leaf) for path, leaf in _walk(tree)}


def _unflatten(flat: Dict[str, np.ndarray], tree_like, prefix: str = ""):
    if isinstance(tree_like, dict):
        return {k: _unflatten(flat, tree_like[k], f"{prefix}{k}/")
                for k in tree_like}
    if isinstance(tree_like, AdamWState):
        return AdamWState(**{name: _unflatten(flat, getattr(tree_like, name),
                                              f"{prefix}.{name}/")
                             for name in _STATE_FIELDS})
    arr = np.asarray(flat[prefix[:-1]])
    if isinstance(tree_like, torch.Tensor):
        t = torch.from_numpy(np.array(arr).reshape(tuple(tree_like.shape)))
        return t.to(device=tree_like.device, dtype=tree_like.dtype)
    return int(arr)


@dataclasses.dataclass
class CheckpointMeta:
    step: int = 0
    epoch: int = 0
    index: int = 0       # data-iterator position
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


class DiskCheckpointer:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def save(self, name: str, tree, meta: CheckpointMeta):
        flat = _flatten(tree)
        np.savez(os.path.join(self.dir, f"{name}.npz"), **flat)
        with open(os.path.join(self.dir, f"{name}.json"), "w") as f:
            json.dump(dataclasses.asdict(meta), f)

    def restore(self, name: str, tree_like) -> Tuple[Any, CheckpointMeta]:
        with np.load(os.path.join(self.dir, f"{name}.npz")) as data:
            flat = dict(data)
        with open(os.path.join(self.dir, f"{name}.json")) as f:
            meta = CheckpointMeta(**json.load(f))
        return _unflatten(flat, tree_like), meta

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.dir, f"{name}.npz"))


class StoreCheckpointer:
    """Checkpoints through the (simulated) object store — bytes are
    accounted so restart overheads show up in time and cost."""

    def __init__(self, object_store):
        self.store = object_store

    def save(self, name: str, tree, meta: CheckpointMeta) -> float:
        flat = _flatten(tree)
        buf = io.BytesIO()
        np.savez(buf, **flat)
        nbytes = buf.getbuffer().nbytes
        self.store.put(f"ckpt/{name}", buf.getvalue(), nbytes=nbytes)
        self.store.put(f"ckpt/{name}.meta", dataclasses.asdict(meta))
        return self.store.put_time(nbytes)

    def restore(self, name: str,
                tree_like) -> Tuple[Any, CheckpointMeta, float]:
        raw = self.store.get(f"ckpt/{name}")
        t = self.store.get_time(len(raw))
        with np.load(io.BytesIO(raw)) as data:
            flat = dict(data)
        meta = CheckpointMeta(**self.store.get(f"ckpt/{name}.meta"))
        return _unflatten(flat, tree_like), meta, t
