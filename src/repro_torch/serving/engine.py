"""Real-model batched serving engine: runs a batch of requests through
prefill and cache decode with greedy sampling; port of the JAX package's
``serving/engine.py``.

Greedy decode is batching-invariant: a request's tokens do not depend on
its batchmates. The batching policy (the reference's ``serving/batcher.py``)
is a numpy layer and is not part of this module.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.core.spans import count, span
from repro_torch.models import registry
from repro_torch.models.base import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray


def modality_stubs(cfg: ModelConfig, batch: int, device) -> dict:
    """The engine's modality frontends, which are stubs: zero image
    embeddings (b, n_image_tokens, d_vision) for vlm and zero audio frames
    (b, n_audio_frames, d_audio) for audio in cfg.dtype, as the
    reference's engine feeds; an empty dict for the other families."""
    if cfg.family == "vlm":
        return {"image_embeds": torch.zeros(
            (batch, cfg.n_image_tokens, cfg.d_vision), dtype=cfg.dtype,
            device=device)}
    if cfg.family == "audio":
        return {"audio_frames": torch.zeros(
            (batch, cfg.n_audio_frames, cfg.d_audio), dtype=cfg.dtype,
            device=device)}
    return {}


class ServingEngine:
    """Fixed-shape batched engine. Requests in one batch must share a
    prompt length (the batcher buckets by length): the models take no
    per-row pad mask, so left-padding would leak pad tokens into
    attention. ``params`` carried across (e.g. ``params_from_numpy``) or
    drawn by ``registry.init(seed, cfg, device)``.

    Where ``registry.decode_replayable`` holds (mamba2 on CUDA, no model
    axis) the decode step is captured once per batch size as a
    ``torch.cuda.CUDAGraph`` (``DecodeGraph``) and replayed for every
    step: the same kernels on the same shapes in the same order as the
    eager step, launched by one call. Every other decode, and every CPU
    run, takes the eager loop. No span or counter may open inside the
    captured step, which records nothing; mamba2's decode path opens
    none. Replacing ``params`` drops the graphs.

    ``last_stats`` holds the last batch's prefill and decode seconds (host
    clock, up to a device synchronise on CUDA). The prefill, through its
    first token, is the span ``serve.prefill``, and each decode step,
    replayed or eager, the span ``serve.decode_step``
    (``core/spans.py``). Each batch makes one record of each counter
    ``serve.decode_replayed`` and ``serve.decode_eager``: its steps
    replayed and run eagerly."""

    def __init__(self, cfg: ModelConfig, params=None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.device = T.resolve_device(device)
        self.params = params if params is not None else registry.init(
            seed, cfg, self.device)
        self.last_stats: dict = {}

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params):
        self._params = params
        self.graphs: dict = {}      # batch size -> DecodeGraph

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def serve_batch(self, requests: List[Request]) -> List[Completion]:
        cfg = self.cfg
        lengths = {len(r.prompt) for r in requests}
        if len(lengths) != 1:
            # the models take no per-row pad mask: left-padding would leak
            # pad tokens into shorter prompts' attention and hand
            # decode_step a wrong pos for them, silently corrupting output
            raise ValueError(
                "serve_batch requires all requests to share a prompt "
                f"length (got lengths {sorted(lengths)}); bucket requests "
                "by length before batching")
        plen = lengths.pop()
        gen = max(r.max_new_tokens for r in requests)
        toks = np.stack([r.prompt for r in requests]).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        batch.update(modality_stubs(cfg, len(requests), self.device))
        self._sync()
        t0 = time.perf_counter()
        with span("serve.prefill"):
            logits, cache = registry.prefill(self.params, cfg, batch,
                                             max_seq=plen + gen)
            tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        self._sync()
        t1 = time.perf_counter()
        out = [tok]
        graph = None
        if gen > 1 and registry.decode_replayable(cfg, self.device):
            graph = self.graphs.get(len(requests))
            if graph is None:
                graph = self.graphs[len(requests)] = DecodeGraph(
                    self.params, cfg, cache, tok, plen)
            graph.load(cache, tok)
            del cache
        for t in range(gen - 1):
            with span("serve.decode_step"):
                if graph is not None:
                    tok = graph.step()
                else:
                    logits, cache = registry.decode_step(
                        self.params, cfg, cache, plen + t, tok)
                    tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
            out.append(tok)
        count("serve.decode_replayed", gen - 1 if graph is not None else 0)
        count("serve.decode_eager", 0 if graph is not None else gen - 1)
        gen_toks = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        self.last_stats = dict(batch=len(requests), prompt_len=plen,
                               new_tokens=gen, prefill_s=t1 - t0,
                               decode_s=time.perf_counter() - t1)
        return [Completion(r.rid, gen_toks[i, :r.max_new_tokens])
                for i, r in enumerate(requests)]


class DecodeGraph:
    """One batch size's decode step captured as a ``torch.cuda.CUDAGraph``
    over buffers at fixed addresses: the stacked cache and the (b, 1)
    token. The graph runs ``registry.decode_step`` on them and the argmax,
    then copies the new cache and token back into them, so each replay
    is one step. ``pos`` is the capture's; only a family whose step
    ignores it (``registry.REPLAYABLE_FAMILIES``) may be captured.

    Captured after one warm-up step on a side stream, as
    ``torch.cuda.graphs`` documents; the warm-up's outputs are dropped and
    the buffers left as ``load`` put them. ``logits`` is the captured
    step's output, in the graph's pool: after a replay, that step's
    logits, until the next."""

    def __init__(self, params, cfg: ModelConfig, cache: dict, tok, pos: int):
        self.cache = {k: torch.empty_like(v) for k, v in cache.items()}
        self.tok = torch.empty_like(tok)
        self.load(cache, tok)
        side = torch.cuda.Stream(device=tok.device)
        side.wait_stream(torch.cuda.current_stream(tok.device))
        with torch.cuda.stream(side):
            self._step(params, cfg, pos, write=False)
        torch.cuda.current_stream(tok.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._step(params, cfg, pos, write=True)

    def _step(self, params, cfg: ModelConfig, pos: int, write: bool):
        logits, cache = registry.decode_step(params, cfg, self.cache, pos,
                                             self.tok)
        tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
        if write:
            self.logits = logits
            for k, x in cache.items():
                self.cache[k].copy_(x)
            self.tok.copy_(tok)

    def load(self, cache: dict, tok):
        """A batch's prefill cache and first token into the buffers."""
        for k, x in cache.items():
            self.cache[k].copy_(x)
        self.tok.copy_(tok)

    def step(self):
        """One decode step; the next token, (b, 1), a tensor of its own."""
        self.graph.replay()
        return self.tok.clone()
