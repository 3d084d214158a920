"""Serving launcher: batched prefill + decode with a KV/SSM cache; port of
the JAX package's ``launch/serve.py`` and its loop: ``reduced_batch``'s
prompts (and, for vlm and audio, its image or audio embeddings) through
``registry.prefill`` (the models cast the embeddings to ``cfg.dtype``),
then greedy ``registry.decode_step``: the engine's loop, on
``reduced_batch``'s modality inputs where the engine feeds zero stubs.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --reduced --requests 4 --prompt-len 32 --gen 16 [--device cpu]

Runs on the CUDA card unless ``--device`` says otherwise; on the card the
phases are timed up to ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced, reduced_batch
from repro_torch.core import tree as T
from repro_torch.models import registry


@torch.no_grad()
def serve(cfg, *, n_requests: int, prompt_len: int, gen: int, seed: int = 0,
          device="cuda"):
    """Returns (tokens (n_requests, gen) int32, prefill seconds, decode
    seconds)."""
    dev = T.resolve_device(device)
    params = registry.init(seed, cfg, dev)
    batch = T.from_numpy(reduced_batch(cfg, n_requests, prompt_len,
                                       seed=seed), dev)
    max_seq = prompt_len + gen
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    t0 = time.perf_counter()
    logits, cache = registry.prefill(params, cfg, batch, max_seq=max_seq)
    tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
    sync()
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        logits, cache = registry.decode_step(params, cfg, cache,
                                             prompt_len + t, tok)
        tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
    return tokens, t_prefill, t_decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    toks, tp, td = serve(cfg, n_requests=args.requests,
                         prompt_len=args.prompt_len, gen=args.gen,
                         device=args.device)
    per_tok = td / max(args.gen - 1, 1) / args.requests
    print(f"prefill {tp*1e3:.0f} ms; decode {td*1e3:.0f} ms "
          f"({per_tok*1e3:.1f} ms/token/request) on {args.device}")
    print("generated:", toks[0, :12].tolist(), "...")
    return toks


if __name__ == "__main__":
    main()
