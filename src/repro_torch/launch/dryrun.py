"""The dry run (port of the JAX package's ``launch/dryrun.py``): trace
every (architecture x input shape x mesh) combination's step as rank 0 of
an H100-cluster mesh runs it, on fake tensors, and read per-rank FLOPs,
bytes, collectives and memory from the trace.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out experiments/dryrun

Where the reference lowers and compiles for fake TPU meshes, the port runs
rank 0's step eagerly under ``FakeTensorMode`` (shapes, dtypes and devices,
no data and no device work) in a fake process group of the mesh's world
size (``torch.testing._internal.distributed.fake_pg``: every collective
returns at once). It runs in an ordinary process and needs no card: fake
tensors take ``device="cuda"`` by default, as the card's program has them,
and ``--device cpu`` where a CPU build of torch cannot run a fake CUDA
backward. Either way the kernels' custom ops (``smlt::flash_attention_fwd``,
``smlt::ssd_scan``) take their fake implementations, so the trace is the
program the card runs: kernel routes, output layouts and FLOP formulas
included. The configs run with ``use_flash_kernel=True``, as the card's
steps do (``--set use_flash_kernel=False`` traces the plain attention).

Per rank, as the reference's keys:
  flops           ``FlopCounterMode`` over the step, the kernels' formulas
                  included;
  bytes_accessed  the sum over aten ops (views excepted) of their input
                  and output bytes. Nothing is fused, so it reads higher
                  than XLA's ``bytes accessed`` of a fused program;
  collectives     ``launch/hlo_stats.py``'s recorder: {op: {count, bytes}},
  collective_bytes  bytes the result operand's size, as the reference's;
  memory          argument_size_in_bytes (the parameters, optimizer state,
                  batch and cache this rank holds), output_size_in_bytes
                  (the step's outputs), peak_memory_in_bytes (the largest
                  sum of live storages during the step, arguments
                  included, each rounded up to 512 bytes as the CUDA
                  caching allocator rounds), temp_size_in_bytes (the peak
                  above the arguments);
  trace_s         the host seconds of the trace (the reference's lower_s;
                  there is no compile_s).

A decode step runs at ``pos = seq_len - 1`` (the reference traces a
symbolic position): the last slot of a full ``seq_len`` cache.

On a mesh with a model axis ("32x8", "2x32x8", the reference's "16x16"
and "2x16x16") rank 0 holds its model parts and runs its heads, experts
and vocabulary columns (``distributed/tensor_parallel.py``); the
recorder counts the model group's collectives with the data group's, and
``--set seq_shard=True`` traces the training step's sequence-parallel
form (its reduce-scatter / all-gather pairs).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, input_specs, pairs, supports
from repro_torch.core import tree as T
# the kernels' FLOP formulas register on import; a FlopCounterMode made
# before then would not see them
from repro_torch.kernels import ops  # noqa: F401
from repro_torch.launch.hlo_stats import CollectiveRecorder
from repro_torch.launch.mesh import (PRODUCTION_MESHES, make_custom_mesh)
from repro_torch.launch.steps import (decode_cache_shapes, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import registry
from repro_torch.models.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.optim.adamw import AdamW


def _alloc(nbytes: int) -> int:
    return -(-nbytes // 512) * 512


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(_alloc(n) for n in seen.values())


class StepCounter(TorchDispatchMode):
    """Counts, over the ops it sees, the bytes they read and write
    (``bytes``: input and output tensors' bytes, views and ``prim``
    metadata queries excepted) and the live storages (``peak``: the most
    bytes alive at once). ``track`` registers tensors made before it was
    entered (the arguments)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}

    def _free(self, key: int):
        self.live -= self._sizes.pop(key)

    def track(self, tensors):
        for t in tensors:
            st = t.untyped_storage()
            if id(st) not in self._sizes:
                self._sizes[id(st)] = n = _alloc(st.nbytes())
                self.live += n
                weakref.finalize(st, self._free, id(st))
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.namespace != "prim":  # data, not metadata
            for x in _tensors((args, kwargs, out)):
                self.bytes += x.numel() * x.element_size()
        self.track(_tensors(out))
        return out


def _tensors(obj):
    """The tensors in nested lists, tuples, dicts and dataclasses (the
    optimizer state)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0, destroyed on leaving."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "none may be initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dryrun_config(arch_id: str, shape: InputShape, *, remat: bool = True,
                  overrides: Optional[Dict] = None,
                  cfg: Optional[ModelConfig] = None) -> ModelConfig:
    """The config a dry run traces: ``cfg`` (default ``ARCHS[arch_id]``)
    with the flash kernel on, remat on a train shape, then
    ``overrides``."""
    cfg = (cfg or ARCHS[arch_id]).replace(use_flash_kernel=True)
    if shape.kind == "train":
        cfg = cfg.replace(remat=remat)
    return cfg.replace(**(overrides or {}))


def make_step(cfg: ModelConfig, shape: InputShape, mesh, *,
              strategy="hier", fsdp=True):
    """This rank's step for ``shape``'s kind on ``mesh`` (built outside
    ``FakeTensorMode``: the mesh's groups hold real tensors)."""
    if shape.kind == "train":
        return make_train_step(cfg, mesh, strategy=strategy, fsdp=fsdp,
                               optimizer=AdamW(lr=3e-4))
    make = make_prefill_step if shape.kind == "prefill" else make_serve_step
    return make(cfg, mesh, fsdp=fsdp)


def step_args(step, cfg: ModelConfig, shape: InputShape, *, device="cuda",
              init=None):
    """The arguments of ``step`` at ``shape``: this rank's parameters
    (``init(full meta params)`` -> full tensors, default uninitialised
    ones, then ``shard_params``), optimizer state and rows of a zero
    batch, and for decode its part of a zero cache. Under
    ``FakeTensorMode`` every tensor is fake."""
    dev = torch.device(device)
    init = init or (lambda p: T.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device=dev), p))
    params = step.shard_params(init(registry.init(0, cfg, device="meta")))
    specs = step.local_batch(input_specs(cfg, shape))
    batch = {k: torch.zeros(x.shape, dtype=x.dtype, device=dev)
             for k, x in specs.items() if k != "pos"}
    if shape.kind == "train":
        return params, step.init_opt_state(params), batch
    if shape.kind == "prefill":
        return params, batch
    extras = {k: v for k, v in specs.items() if k not in ("tokens", "pos")}
    cache = step.shard_cache(T.tree_map(
        lambda x: torch.zeros(x.shape, dtype=x.dtype, device=dev),
        decode_cache_shapes(cfg, batch["tokens"].shape[0], shape.seq_len,
                            extras or None)))
    return params, cache, shape.seq_len - 1, batch["tokens"]


def lower_one(arch_id: str, shape_name: Union[str, InputShape], *,
              multi_pod: bool, strategy: str = "hier", fsdp: bool = True,
              remat: bool = True, mesh_shape: Optional[str] = None,
              overrides: Optional[Dict] = None, device="cuda",
              cfg: Optional[ModelConfig] = None) -> Dict:
    """Trace rank 0's step of ``arch_id`` (or ``cfg``) at ``shape_name``
    (an ``INPUT_SHAPES`` name or an ``InputShape``) on the production mesh
    (``multi_pod``) or ``mesh_shape``, on fake tensors on ``device``;
    returns the per-rank terms of the module docstring."""
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    cfg = dryrun_config(arch_id, shape, remat=remat, overrides=overrides,
                        cfg=cfg)
    mesh_name = mesh_shape or PRODUCTION_MESHES[multi_pod]
    world = 1
    for d in mesh_name.split("x"):
        world *= int(d)
    dev = torch.device(device)
    t0 = time.perf_counter()
    with fake_world(world):
        from torch._subclasses.fake_tensor import FakeTensorMode
        mesh = make_custom_mesh(mesh_name, dev.type)
        step = make_step(cfg, shape, mesh, strategy=strategy, fsdp=fsdp)
        with FakeTensorMode():
            args = step_args(step, cfg, shape, device=dev)
            held = list(_tensors(args))
            arg_bytes = _storage_bytes(held)
            flops = FlopCounterMode(display=False)
            with flops, StepCounter() as count, CollectiveRecorder() as rec:
                count.track(held)
                out = step(*args)
            out_bytes = _storage_bytes(_tensors(out))
            del out, args, held, step
    coll = rec.stats()
    return {
        "arch": arch_id, "shape": shape.name, "mesh": mesh_name,
        "device": dev.type, "strategy": strategy, "fsdp": fsdp,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(count.bytes),
        "collectives": coll,
        "collective_bytes": sum(d["bytes"] for d in coll.values()),
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": count.peak - arg_bytes,
                   "peak_memory_in_bytes": count.peak},
        "trace_s": round(time.perf_counter() - t0, 1),
        "params": registry.param_count(cfg),
        "active_params": registry.param_count(cfg, active_only=True),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--strategy", default="hier",
                    choices=["hier", "hier1", "allreduce"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default=None, help="dir for per-pair JSON")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="custom mesh, e.g. 8x1, 2x4x1, 32x8 or 2x16x16 "
                    "(data x model, pod x data x model)")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override, e.g. --set moe_group=1024")
    ap.add_argument("--tag", default="", help="suffix for the output JSON")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu on a CPU-only torch)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            import ast
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    if args.all:
        todo = list(pairs())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        if not supports(args.arch, args.shape):
            print(f"SKIP {args.arch} x {args.shape}: unsupported")
            return
        todo = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch_id, shape_name in todo:
        for mp in meshes:
            mesh_name = args.mesh_shape or PRODUCTION_MESHES[mp]
            tag = (f"{arch_id}__{shape_name}__{mesh_name}"
                   f"__{args.strategy}{'' if not args.no_fsdp else '__nofsdp'}"
                   f"{args.tag}")
            if args.out and args.skip_existing:
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"skip {tag} (exists)")
                    continue
            print(f"=== {tag} ===", flush=True)
            try:
                res = lower_one(arch_id, shape_name, multi_pod=mp,
                                strategy=args.strategy, fsdp=not args.no_fsdp,
                                mesh_shape=args.mesh_shape,
                                overrides=overrides or None,
                                device=args.device)
            except Exception as e:
                traceback.print_exc()
                failures.append((tag, repr(e)))
                continue
            print(json.dumps(
                {k: res[k] for k in ("flops", "bytes_accessed",
                                     "collective_bytes", "memory",
                                     "trace_s")}, indent=1), flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
    if failures:
        print("FAILURES:")
        for tag, e in failures:
            print(" ", tag, e)
        raise SystemExit(1)
    print("dry-run complete: every combination traced")


if __name__ == "__main__":
    main()
