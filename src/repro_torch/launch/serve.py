"""Serving launcher: batched prefill + decode with a KV/SSM cache; port of
the JAX package's ``launch/serve.py``, running one batch through
``serving.ServingEngine``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --reduced --requests 4 --prompt-len 32 --gen 16 [--device cpu]

Runs on the CUDA card unless ``--device`` says otherwise; on the card the
phases are timed up to ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCHS, reduced, reduced_batch
from repro_torch.serving import Request, ServingEngine


def serve(cfg, *, n_requests: int, prompt_len: int, gen: int, seed: int = 0,
          device="cuda"):
    """Returns (tokens (n_requests, gen) int32, prefill seconds, decode
    seconds)."""
    engine = ServingEngine(cfg, seed=seed, device=device)
    prompts = reduced_batch(cfg, n_requests, prompt_len, seed=seed)["tokens"]
    out = engine.serve_batch([Request(i, p, gen)
                              for i, p in enumerate(prompts)])
    stats = engine.last_stats
    return (np.stack([c.tokens for c in out]), stats["prefill_s"],
            stats["decode_s"])


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
