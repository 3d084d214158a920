"""The steps over a ``torch.distributed`` mesh (port of the JAX package's
``launch/steps.py``): ``make_train_step``, ``make_prefill_step``,
``make_serve_step`` and ``decode_cache_shapes``.

The SMLT synchronization strategy is a first-class knob of the training
step:

  "allreduce" — every gradient is all-reduced over the data (x pod) ranks
                and every rank applies the whole update (the naive
                baseline);
  "hier"      — SMLT's hierarchical ScatterReduce: each gradient leaf that
                the sharding rules split over ``data`` is reduce-scattered
                along that dim, the optimizer runs on this rank's shard
                only (its moments are held for the shard alone: ZeRO-style
                state, each worker the paper's shard aggregator), and the
                updated shards are all-gathered. On a (pod, data) mesh the
                scatter and gather stay inside a pod, and the reduced shard
                is reduce-scattered across pods, so the optimizer state
                spans pod x data as the reference's ``ospecs`` do (a shard
                that does not divide by the pod count is all-reduced
                across pods instead): the 2-level hierarchy;
  "hier1"     — the flat 1-level variant over (pod, data) jointly.

Leaves the rules leave unsplit (small or indivisible) are all-reduced, and
their update is replicated. Each rank computes the gradient of
``registry.loss_fn`` on its contiguous slice of the global batch, with
``cross_entropy`` dividing by the mean over the data ranks of their counts
of labels >= 0 (``models/layers.py::global_label_count``): the ranks'
losses and gradients then sum to the global batch's, every token weighted
alike as in the reference, whatever labels are masked (-1). The loss is
the mean of the ranks' losses. The collectives run at every world size,
one included.

``fsdp=True`` (every step) is ZeRO-3 over every data-like axis, on the
reference's ``param_specs(..., fsdp_axis=data axes, fsdp_divisor=data
size)``: each rank holds its part of every leaf those specs split
(``shard_params``). Leaves outside the layer stacks are all-gathered once
at the start of a step; a stacked leaf reaches the layer loops as
per-layer shards that the layer hook (``models/transformer.py::
gather_layer``) all-gathers just before its layer runs, inside the
checkpointed body under ``cfg.remat``. The gather's backward is a
reduce-scatter, so gradients leave the step as this rank's parts and
AdamW runs on them.

A ``model`` axis > 1 is tensor parallelism (``distributed/
tensor_parallel.py``): each rank holds the model part of every leaf the
reference's ``param_specs(..., model_size)`` split over ``model`` (and,
under ``fsdp``, its data part of that), and the model runs inside
``tensor_parallel.model_parallel`` on those parts. The ranks of one model
coordinate form the data group: the batch, the gradient sync, ZeRO-3 and
the ``hier`` state work there as they do without a model axis. The
prefill and serve steps hold their caches split as ``cache_specs`` says
(``shard_cache``). Every family takes a model axis;
``registry.check_model_axis`` raises only where a model cannot split
(a rank without a head, SSM heads the axis does not divide).

Under ``cfg.seq_shard`` the training step runs the model in
``model_parallel``'s sequence-parallel mode: between the layers each model
rank holds its slice of the sequence, which must divide by the model
axis. A whole leaf that the model reads on a slice (the norms' scales and
biases, the vlm gates, an unsplit MLP) or that only this rank's heads
read on the gathered sequence (the SSM layers' B / C projections and
conv) would then have a partial gradient on each model rank; the layer
that reads it does so through ``tensor_parallel.seq_leaf``, whose
backward sums it over the model group, so that every rank's copy takes
the same update. Every other leaf keeps its whole gradient, as without
the mode. The prefill and serve steps keep the stream whole on every
rank: with a cache the reference skips ``seq_constraint`` in most
families, and the constraint changes no number.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core import tree as T
from repro_torch.core.hier_sync import all_gather, all_reduce, reduce_scatter
from repro_torch.core.spans import span
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (cache_specs, gather_model_part,
                                              is_stacked, model_part,
                                              param_specs, placement)
from repro_torch.launch.mesh import (axis_index, axis_size, data_axes,
                                     data_group, data_index, data_size,
                                     model_group)
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.base import ModelConfig
from repro_torch.optim.adamw import AdamW, AdamWState

# the reference's param_specs default: ZeRO-3 splits the leaves of 2**20
# elements or more (none of a reduced config's: the tests lower it)
FSDP_MIN_SIZE = 2 ** 20


def _grad_axes(mesh, strategy: str):
    if strategy == "hier":
        return "data"
    if strategy == "hier1":
        return data_axes(mesh)
    if strategy == "allreduce":
        return None
    raise ValueError(f"unknown train sync strategy {strategy!r}")


@dataclasses.dataclass
class _Shard:
    """One leaf split along ``dim`` into ``n`` parts over ``group``; this
    rank holds part ``index``. On a pod mesh under ``hier``, ``pod_group``
    joins this rank to its peers in the other pods: with ``pod_n`` > 1 the
    reduced part is split again across the pods (this rank keeps part
    ``pod_index`` of it), with ``pod_n`` 1 it is summed across them.
    ``clip_group`` spans the ranks whose parts make up the whole leaf."""
    dim: int
    group: Any
    n: int
    index: int
    clip_group: Any
    pod_group: Any = None
    pod_n: int = 1
    pod_index: int = 0

    def take(self, x):
        """This rank's part of a full tensor (a view)."""
        k = x.shape[self.dim] // (self.n * self.pod_n)
        return x.narrow(self.dim, (self.index * self.pod_n + self.pod_index)
                        * k, k)

    def scatter(self, g):
        """The summed gradient's part for this rank, contiguous in g's dim
        order (so that the clip's sums read every path's gradients in one
        order)."""
        out = _rows(reduce_scatter, g.movedim(self.dim, 0).contiguous(),
                    self.n, self.group)
        if self.pod_group is not None:
            if self.pod_n > 1:
                out = _rows(reduce_scatter, out, self.pod_n, self.pod_group)
            else:
                all_reduce(out, self.pod_group)
        return out.movedim(0, self.dim).contiguous()

    def gather(self, part):
        """Every rank's part, concatenated back along ``dim``."""
        moved = part.movedim(self.dim, 0).contiguous()
        if self.pod_n > 1:
            moved = _rows(all_gather, moved, self.pod_n, self.pod_group)
        return _rows(all_gather, moved, self.n, self.group) \
            .movedim(0, self.dim).contiguous()


def _rows(collective, x, n: int, group):
    """``reduce_scatter`` (n times fewer rows out) or ``all_gather`` (n
    times more) of ``x`` over ``group`` into a new tensor."""
    rows = x.shape[0] // n if collective is reduce_scatter else \
        x.shape[0] * n
    out = torch.empty((rows,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return collective(out, x, group)


class _Gather(torch.autograd.Function):
    """ZeRO-3's gather of a parameter part; its backward reduce-scatters
    the full gradient back to this rank's part (summed over the ranks)."""

    @staticmethod
    def forward(ctx, part, shard):
        ctx.shard = shard
        return shard.gather(part)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.scatter(g), None


@dataclasses.dataclass
class _Sharded:
    """A ZeRO-3 part as the model sees it: a stacked leaf's part unbinds
    into per-layer parts, and ``gather`` (the layer hook) gathers one."""
    part: Any
    shard: _Shard

    def unbind(self):
        layer = dataclasses.replace(self.shard, dim=self.shard.dim - 1)
        return [_Sharded(x, layer) for x in torch.unbind(self.part, 0)]

    def gather(self):
        return _Gather.apply(self.part, self.shard)


@dataclasses.dataclass
class _Step:
    """What every step shares: the config, this rank's place in the
    global batch, the model dim of each parameter leaf that tensor
    parallelism splits (None where the leaf is whole on every model rank)
    and, under ``fsdp``, the ZeRO-3 split of each leaf's model part (None
    where it stays whole)."""
    cfg: ModelConfig
    fsdp: List[Optional[_Shard]]      # per param leaf, in leaves order
    stacked: List[bool]               # gathered per layer (else at start)
    group: Any                        # the data-like ranks of this model
    n_data: int                       # coordinate
    index: int
    model: List[Optional[int]] = None  # per param leaf: its model dim
    model_group: Any = None
    n_model: int = 1
    model_index: int = 0

    def _model_take(self, x, dim):
        return model_part(x, dim, self.n_model, self.model_index)

    def local_batch(self, batch):
        """This rank's contiguous rows of a global batch (a tree of numpy
        arrays or tensors); a batch that does not divide stays whole, as
        ``distributed.sharding.batch_specs`` leaves it replicated."""
        def rows(x):
            if not len(x.shape) or x.shape[0] % self.n_data:
                return x
            k = x.shape[0] // self.n_data
            return x[self.index * k:(self.index + 1) * k]
        return T.tree_map(rows, batch)

    def shard_params(self, params):
        """Full parameters -> what this rank holds: its model part of
        every leaf split over ``model``, and of that its ZeRO-3 part,
        copied; the other leaves as they are."""
        out = []
        for x, z, md in zip(T.leaves(params), self.fsdp, self.model):
            part = self._model_take(x, md)
            part = part if z is None else z.take(part)
            out.append(part if part is x else part.clone())
        return T.unflatten(params, out)

    def gather_params(self, params):
        """What this rank holds -> the full parameters, on every rank."""
        return T.unflatten(params, [
            gather_model_part(x if z is None else z.gather(x), md,
                              self.model_group)
            for x, z, md in zip(T.leaves(params), self.fsdp, self.model)])

    def _cache_dims(self, like):
        """The model dim (or None) of each leaf of a cache whose whole
        shapes are ``like``'s, as ``cache_specs`` splits it."""
        return [placement(spec, self.n_model)[1] for spec in T.leaves(
            cache_specs(like, ("data",), model_size=self.n_model))]

    def shard_cache(self, cache):
        """A whole cache of this rank's rows -> its model part, as
        ``cache_specs`` splits it (copied; the cache itself on a model axis
        of 1)."""
        if self.n_model == 1:
            return cache
        return T.unflatten(cache, [
            x if md is None else self._model_take(x, md[0]).clone()
            for x, md in zip(T.leaves(cache), self._cache_dims(cache))])

    def gather_cache(self, cache):
        """The inverse of ``shard_cache``: every model rank's part of
        each leaf, concatenated."""
        if self.n_model == 1:
            return cache
        like = T.unflatten(cache, [
            torch.empty(_whole_cache_shape(self.cfg, p, x.shape),
                        device="meta")
            for p, x in T.leaves_with_path(cache)])
        return T.unflatten(cache, [
            x if md is None else gather_model_part(x, md[0],
                                                   self.model_group)
            for x, md in zip(T.leaves(cache), self._cache_dims(like))])

    def model_params(self, params):
        """The tree the model takes: unstacked ZeRO-3 leaves gathered
        here, stacked ones as per-layer parts for the layer hook."""
        return T.unflatten(params, [
            x if z is None else (_Sharded(x, z) if st else
                                 _Gather.apply(x, z))
            for x, z, st in zip(T.leaves(params), self.fsdp, self.stacked)])


@dataclasses.dataclass
class TrainStep(_Step):
    """``step(params, opt_state, local_batch) -> (params, opt_state,
    loss)``, called by every rank of the mesh with its rows of the global
    batch (``local_batch``). ``params`` are what this rank holds (replicated
    without ``fsdp``; ``shard_params`` of the full ones with it); each
    split leaf's moments in ``opt_state`` hold this rank's part
    (``init_opt_state``, ``shard_opt_state`` and ``gather_opt_state`` move
    between that and the full state)."""
    optimizer: AdamW = None
    shards: List[Optional[_Shard]] = None  # the gradient split, non-ZeRO-3

    def _state_shards(self):
        return [z or s for z, s in zip(self.fsdp, self.shards)]

    def _held_parts(self, params):
        """This rank's optimizer parts of the parameters it holds."""
        return T.unflatten(params, [
            x if z is not None or s is None else s.take(x)
            for x, z, s in zip(T.leaves(params), self.fsdp, self.shards)])

    def init_opt_state(self, params) -> AdamWState:
        return self.optimizer.init(self._held_parts(params))

    def shard_opt_state(self, state: AdamWState) -> AdamWState:
        """A full optimizer state (a checkpoint's) -> this rank's parts,
        copied."""
        def part(t):
            out = []
            for x, s, md in zip(T.leaves(t), self._state_shards(),
                                self.model):
                x = self._model_take(x, md)
                out.append((x if s is None else s.take(x)).clone())
            return T.unflatten(t, out)
        return AdamWState(step=state.step, mu=part(state.mu),
                          nu=part(state.nu))

    def gather_opt_state(self, state: AdamWState) -> AdamWState:
        """This rank's parts -> the full optimizer state, on every rank."""
        def full(t):
            return T.unflatten(t, [
                gather_model_part(x.clone() if s is None else s.gather(x),
                                  md, self.model_group)
                for x, s, md in zip(T.leaves(t), self._state_shards(),
                                    self.model)])
        return AdamWState(step=state.step, mu=full(state.mu),
                          nu=full(state.nu))

    def _clip_groups(self):
        """Per leaf, the groups its gradient part is split over (the
        clip's sums): the state shard's, then the model group's."""
        out = []
        for s, md in zip(self._state_shards(), self.model):
            groups = ((() if s is None else (s.clip_group,))
                      + (() if md is None else (self.model_group,)))
            out.append(groups[0] if len(groups) == 1 else groups or None)
        return out

    def loss_and_grads(self, params, batch):
        """This rank's loss and the gradient of the parameters it holds,
        before the data-parallel sync."""
        cfg = self.cfg
        registry.check_model_axis(cfg, self.n_model, [
            x.shape[1] for k, x in batch.items()
            if k in ("tokens", "audio_frames")])
        with tp.model_parallel(self.model_group, seq=cfg.seq_shard), \
                L.global_label_count(self.group, self.n_data):
            return T.value_and_grad(lambda p, b: registry.loss_fn(
                self.model_params(p), cfg, b))(params, batch)

    def __call__(self, params, opt_state: AdamWState, batch):
        """The spans (``core/spans.py``): ``autograd.forward`` and
        ``autograd.backward`` in ``loss_and_grads``; the sync of the
        gradient, each leaf scattered or all-reduced and divided, is
        ``exchange.reduce_scatter``; ``adamw.update``; the gather of the
        updated parts and the loss's all-reduce, ``exchange.all_gather``."""
        loss, grads = self.loss_and_grads(params, batch)
        gl = T.leaves(grads)
        with span("exchange.reduce_scatter"):
            for i, (z, s) in enumerate(zip(self.fsdp, self.shards)):
                if z is not None:   # summed into this part by the gathers
                    gl[i] = gl[i] / self.n_data
                elif s is None:
                    gl[i] = all_reduce(gl[i], self.group) / self.n_data
                else:
                    gl[i] = s.scatter(gl[i]) / self.n_data
        new_parts, opt_state = self.optimizer.update(
            T.unflatten(params, gl), opt_state, self._held_parts(params),
            sharded=T.unflatten(params, self._clip_groups()))
        del gl
        with span("exchange.all_gather"):
            new = [x if s is None else s.gather(x)
                   for x, s in zip(T.leaves(new_parts), self.shards)]
            all_reduce(loss, self.group)
        return T.unflatten(params, new), opt_state, loss / self.n_data


@dataclasses.dataclass
class PrefillStep(_Step):
    """``step(params, local_batch, max_seq=None) -> (logits, cache)``:
    ``registry.prefill`` on this rank's rows, with no gradient; ``max_seq``
    sizes the cache for the decode that follows (the prompt's length by
    default, as in the reference). Under tensor parallelism the logits are
    this rank's columns of the vocabulary and the cache its model part
    (``gather_cache``, ``tensor_parallel.gather_from_model`` make them
    whole); the stream stays whole on every rank under ``seq_shard`` too
    (the module docstring)."""

    def __call__(self, params, batch, max_seq: Optional[int] = None):
        with torch.no_grad(), tp.model_parallel(self.model_group):
            return registry.prefill(self.model_params(params), self.cfg,
                                    batch, max_seq=max_seq)


@dataclasses.dataclass
class ServeStep(_Step):
    """``step(params, cache, pos, tokens) -> (logits, cache)``: one new
    token per row of this rank's (b, 1) ``tokens`` against its rows of a
    ``max_seq`` cache (``registry.decode_step``), with no gradient."""

    def __call__(self, params, cache, pos, tokens):
        with torch.no_grad(), tp.model_parallel(self.model_group):
            return registry.decode_step(self.model_params(params), self.cfg,
                                        cache, pos, tokens)


def _base(cfg: ModelConfig, mesh, fsdp: bool) -> dict:
    """The fields of ``_Step`` for ``mesh``: the model dim of each leaf the
    specs split over a model axis > 1, and the ZeRO-3 split of each leaf of
    at least ``FSDP_MIN_SIZE`` elements over the data-like ranks of this
    model coordinate when ``fsdp``."""
    pshapes = registry.init(0, cfg, device="meta")
    model_n = axis_size(mesh, "model")
    registry.check_model_axis(cfg, model_n)
    group, n_data = data_group(mesh), data_size(mesh)
    paths = [p for p, _ in T.leaves_with_path(pshapes)]
    split, mdims = [None] * len(paths), [None] * len(paths)
    pspecs = param_specs(pshapes, model_size=model_n,
                         fsdp_axis=data_axes(mesh) if fsdp else None,
                         fsdp_min_size=FSDP_MIN_SIZE, fsdp_divisor=n_data)
    index = data_index(mesh)
    for i, spec in enumerate(T.leaves(pspecs)):
        data, model = placement(spec, model_n)
        mdims[i] = model and model[0]
        if data is not None:
            split[i] = _Shard(dim=data[0], group=group, n=n_data,
                              index=index, clip_group=group)
    return dict(cfg=cfg, fsdp=split,
                stacked=[is_stacked(p) for p in paths],
                group=group, n_data=n_data, index=index, model=mdims,
                model_group=model_group(mesh) if model_n > 1 else None,
                n_model=model_n, model_index=axis_index(mesh, "model"))


def make_train_step(cfg: ModelConfig, mesh, *, strategy: str = "hier",
                    fsdp: bool = False,
                    optimizer: Optional[AdamW] = None) -> TrainStep:
    """The training step of ``strategy`` over ``mesh`` (see the module
    docstring); every rank of the mesh builds it together."""
    gaxes = _grad_axes(mesh, strategy)
    pshapes = registry.init(0, cfg, device="meta")
    base = _base(cfg, mesh, fsdp)
    shards = [None] * len(base["fsdp"])
    if gaxes:
        # the reference's ZeRO layout: gradients constrained to the
        # reduce-scatter placement of these specs
        zspecs = param_specs(pshapes, model_size=base["n_model"],
                             fsdp_axis=gaxes,
                             fsdp_min_size=2 ** 14,
                             fsdp_divisor=(base["n_data"] if strategy ==
                                           "hier1" else
                                           axis_size(mesh, "data")))
        two_level = strategy == "hier" and axis_size(mesh, "pod") > 1
        g = mesh.get_group("data") if strategy == "hier" else base["group"]
        n_pod = axis_size(mesh, "pod") if two_level else 1
        for i, (spec, leaf) in enumerate(zip(T.leaves(zspecs),
                                             T.leaves(pshapes))):
            where, _ = placement(spec, base["n_model"])
            if where is None or base["fsdp"][i] is not None:
                continue
            n = dist.get_world_size(g)
            pod_n = n_pod if leaf.shape[where[0]] % (n * n_pod) == 0 else 1
            shards[i] = _Shard(
                dim=where[0], group=g, n=n, index=dist.get_rank(g),
                clip_group=base["group"] if pod_n > 1 else g,
                pod_group=mesh.get_group("pod") if two_level else None,
                pod_n=pod_n,
                pod_index=axis_index(mesh, "pod") if pod_n > 1 else 0)
    return TrainStep(**base, optimizer=optimizer or AdamW(lr=3e-4),
                     shards=shards)


def make_prefill_step(cfg: ModelConfig, mesh, *,
                      fsdp: bool = False) -> PrefillStep:
    """step(params, local_batch, max_seq=None) -> (logits, cache)."""
    return PrefillStep(**_base(cfg, mesh, fsdp))


def make_serve_step(cfg: ModelConfig, mesh, *,
                    fsdp: bool = False) -> ServeStep:
    """step(params, cache, pos, tokens) -> (logits, cache): ONE new token
    against a max_seq KV/SSM cache."""
    return ServeStep(**_base(cfg, mesh, fsdp))


def _whole_cache_shape(cfg: ModelConfig, path: str, shape) -> tuple:
    """The whole shape of a cache leaf at ``path`` of which a model rank
    holds ``shape``: the keys' and values' heads and head dim, the SSM
    state's heads, state and head dim, and the conv state's d_inner from
    the config; the rest as it is."""
    name, shape = path.rsplit("/", 1)[-1], tuple(shape)
    if name in ("k", "v"):
        return shape[:-2] + (cfg.n_kv_heads, cfg.resolved_head_dim)
    if name == "ssm":
        return shape[:-3] + (cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_headdim)
    if name == "conv_x":
        return shape[:-1] + (cfg.d_inner,)
    return shape


def decode_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                        extras_shapes=None):
    """The decode cache as meta tensors (``registry.init_decode_cache`` on
    meta parameters: nothing is allocated). ``extras_shapes`` holds the vlm
    and audio models' modality inputs (``configs.batch_extras``)."""
    pshapes = registry.init(0, cfg, device="meta")
    with torch.no_grad():
        return registry.init_decode_cache(pshapes, cfg, batch, max_seq,
                                          batch_extras=extras_shapes)
