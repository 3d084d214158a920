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

    ``last_stats`` holds the last batch's prefill and decode seconds (host
    clock, up to a device synchronise on CUDA)."""

    def __init__(self, cfg: ModelConfig, params=None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.device = T.resolve_device(device)
        self.params = params if params is not None else registry.init(
            seed, cfg, self.device)
        self.last_stats: dict = {}

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
        logits, cache = registry.prefill(self.params, cfg, batch,
                                         max_seq=plen + gen)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        self._sync()
        t1 = time.perf_counter()
        out = [tok]
        for t in range(gen - 1):
            logits, cache = registry.decode_step(self.params, cfg, cache,
                                                 plen + t, tok)
            tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
            out.append(tok)
        gen_toks = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        self.last_stats = dict(batch=len(requests), prompt_len=plen,
                               new_tokens=gen, prefill_s=t1 - t0,
                               decode_s=time.perf_counter() - t1)
        return [Completion(r.rid, gen_toks[i, :r.max_new_tokens])
                for i, r in enumerate(requests)]
