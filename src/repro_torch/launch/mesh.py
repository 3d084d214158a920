"""Device meshes over ``torch.distributed`` (port of the JAX package's
``launch/mesh.py``), with the reference's axis names ``pod``, ``data`` and
``model``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``: every rank of
the default process group holds one position of it, and
``mesh.get_group(axis)`` is the group of the ranks that differ only along
``axis``. The reference's 16x16 / 2x16x16 TPU production meshes
(``make_production_mesh``) do not carry over to H100 hosts; their
counterpart waits for the dry-run tools (ROADMAP A16).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core import tree as T


def make_custom_mesh(shape_str: str, device_type: str = "cuda"):
    """'8x1' -> (data=8, model=1); '2x4x1' -> (pod=2, data=4, model=1),
    over the ranks of the default process group in row-major order."""
    dims = tuple(int(x) for x in shape_str.split("x"))
    if len(dims) == 2:
        names = ("data", "model")
    elif len(dims) == 3:
        names = ("pod", "data", "model")
    else:
        raise ValueError(shape_str)
    return init_device_mesh(device_type, dims, mesh_dim_names=names)


def data_axes(mesh) -> tuple:
    """The batch-sharding axes of a mesh (pod folds into data-parallel)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def data_size(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 on an absent axis)."""
    names = mesh.mesh_dim_names
    return mesh.get_coordinate()[names.index(name)] if name in names else 0


def data_index(mesh) -> int:
    """This rank's position in the (pod, data) row-major order the batch
    is split in."""
    i = 0
    for a in data_axes(mesh):
        i = i * axis_size(mesh, a) + axis_index(mesh, a)
    return i


def data_group(mesh):
    """One process group over every data-like axis of ``mesh`` (pod x data
    when both are there), ranks in ``data_index`` order. Every rank of the
    default group must call this together (it may create a group)."""
    axes = data_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if axis_size(mesh, "model") != 1:
        raise NotImplementedError(
            "a model axis > 1 is not ported yet (ROADMAP A16)")
    return dist.new_group(ranks=mesh.mesh.flatten().tolist())


@contextlib.contextmanager
def process_group(device="cuda"):
    """Run the block inside a process group: the one already initialised,
    or a one-rank group made here (NCCL for a CUDA device, gloo for the
    CPU, on an in-memory store) and destroyed on leaving."""
    if dist.is_initialized():
        yield
        return
    dev = T.resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
