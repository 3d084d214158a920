"""Batched serving demo: prefill + KV/SSM-cache decode on zoo models (the
port's counterpart of the JAX package's ``examples/serve_batched.py``).

Serves a batch of requests on reduced configs of one attention model and
one attention-free (SSM) model — the two cache disciplines the decode
dry-run shapes exercise.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
import argparse

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for arch in ("qwen2.5-3b", "mamba2-2.7b"):
        cfg = reduced(ARCHS[arch])
        toks, tp, td = serve(cfg, n_requests=4, prompt_len=32, gen=12,
                             device=args.device)
        per = td / 11 / 4 * 1e3
        print(f"{arch:14s} (reduced): prefill {tp*1e3:6.0f} ms, "
              f"decode {per:5.1f} ms/token/request, "
              f"sample: {toks[0, :8].tolist()}")


if __name__ == "__main__":
    main()
