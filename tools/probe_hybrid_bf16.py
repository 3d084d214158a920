#!/usr/bin/env python3
"""How far zamba2-7b's bf16 kernel path lies from its plain bf16 path at
full width, across depths and seeds, and whether chip_smoke.py's phase 12
checks catch a kernel with more error or a wiring fault.

    python3 tools/probe_hybrid_bf16.py [--seeds 0 1 2] [--depths 1 2 7 13]

For each seed and depth, zamba2-7b's config at full width (random weights
from the seed) runs hybrid.forward_full on chip_smoke.py's HYBRID_BATCH x
HYBRID_SEQ tokens, and the last position's logits are compared by their
relative norm error ||a - b|| / ||b||: the f32 forward of the same
weights, the plain bf16 path (kernels off), and the bf16 paths with both
kernels, the flash kernel alone and the SSD kernel alone.

At phase 12's depth (attn_every + 1) each seed also runs phase 12's
checks on the real kernels and on controls, each a kernel with more error
or a wiring fault: flash_x2, flash_x4 (at every call the flash kernel's
own error against its plain version, scaled by 2 or 4), ssd_x2, ssd_x4
(the same for the SSD's y), ssd_bc_swap (the SSD given C for B and B for
C), flash_window (the model's window cut to a quarter before the call):
  - every kernel call held against its plain version on the model's
    inputs (chip_smoke.held_against_plain), both kernels on;
  - the last position's logits with the flash kernel alone against the
    plain path (HYBRID_FLASH_LOGITS_REL_NORM), beside sdpa: the plain
    path with the shared block's attention through torch's
    scaled_dot_product_attention, a second correct bf16 attention;
  - for the record, not held: both kernels' logits against the plain
    path, with flash_x4 and ssd_x4.
Prints the card's name and power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (imports no torch at module level)


@contextlib.contextmanager
def patched(obj, name: str, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, old)


def scaled_flash(ops, fa, scale: float):
    """ops.flash_attention whose error against the plain version is
    ``scale`` times the kernel's."""
    real = ops.flash_attention

    def f(q, k, v, *, causal, window, **kw):
        got = real(q, k, v, causal=causal, window=window, **kw).float()
        want = fa.plain_flash_attention(q, k, v, causal=causal,
                                        window=window).float()
        return (want + scale * (got - want)).to(q.dtype)
    return f


def scaled_ssd(ops, ssd, scale: float):
    """ops.ssd_scan whose y error against the plain version is ``scale``
    times the kernel's (the model's sequence is a multiple of its chunk)."""
    real = ops.ssd_scan

    def f(x, dt, A, B, C, D, *, chunk):
        y, S = real(x, dt, A, B, C, D, chunk=chunk)
        wy, _ = ssd.plain_ssd_scan(x, dt, A, B, C, D, chunk)
        return (wy.float() + scale * (y.float() - wy.float())).to(y.dtype), S
    return f


def narrow_window(ops):
    real = ops.flash_attention

    def f(q, k, v, *, causal, window, **kw):
        return real(q, k, v, causal=causal, window=window // 4, **kw)
    return f


def swapped_bc(ops):
    real = ops.ssd_scan

    def f(x, dt, A, B, C, D, *, chunk):
        return real(x, dt, A, C, B, D, chunk=chunk)
    return f


def sdpa_attention(q, k, v, *, causal, q_offset=0, sliding_window=0):
    """blockwise_attention's function where the window does not bite."""
    import torch.nn.functional as F
    unbounded = not sliding_window or sliding_window >= q.shape[1]
    cs.require(causal and q_offset == 0 and unbounded,
               "sdpa stands in only for causal attention without a "
               "binding window")
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True)
    return out.transpose(1, 2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2, 7, 13])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_hybrid_bf16: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS
    from repro_torch.core import tree as T
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import hybrid, layers, registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), "|", torch.__version__, torch.version.cuda,
          flush=True)
    _build.load()
    device = torch.device("cuda", 0)
    full = ARCHS["zamba2-7b"]
    wiring_depth = full.attn_every + 1
    bound = cs.HYBRID_FLASH_LOGITS_REL_NORM
    controls = {                          # name -> (ops attribute, wrapper)
        "flash_x2": ("flash_attention", lambda: scaled_flash(ops, fa, 2.0)),
        "flash_x4": ("flash_attention", lambda: scaled_flash(ops, fa, 4.0)),
        "ssd_x2": ("ssd_scan", lambda: scaled_ssd(ops, ssd, 2.0)),
        "ssd_x4": ("ssd_scan", lambda: scaled_ssd(ops, ssd, 4.0)),
        "ssd_bc_swap": ("ssd_scan", lambda: swapped_bc(ops)),
        "flash_window": ("flash_attention", lambda: narrow_window(ops)),
    }
    print(f"zamba2-7b at d_model {full.d_model}, {cs.HYBRID_BATCH} x "
          f"{cs.HYBRID_SEQ} tokens, last-position logits; relative norm "
          f"errors; phase 12's depth {wiring_depth}", flush=True)
    loader = cs.make_loader(full, cs.HYBRID_SEQ)
    toks = T.from_numpy(loader.next_batch(cs.HYBRID_BATCH),
                        device)["tokens"]

    def last(params, cfg, kernels=()):
        on = cfg.replace(**{f"use_{k}_kernel": True for k in kernels})
        with torch.no_grad():
            return hybrid.forward_full(params, on, toks)[0][:, -1].float()

    def verdict(r):
        return f"{r:.3e} {'pass' if r < bound else 'FAIL'}"

    def held(params, cfg, control=None):
        """Both kernels on, each call held against its plain version;
        returns the verdict."""
        calls = []
        with contextlib.ExitStack() as stack:
            wiring = control == "flash_window"
            if control and not wiring:   # beneath the hold: a kernel fault
                attr, make = controls[control]
                stack.enter_context(patched(ops, attr, make()))
            stack.enter_context(cs.held_against_plain(calls))
            if wiring:                   # above it: the model's call
                stack.enter_context(patched(ops, "flash_attention",
                                            narrow_window(ops)))
            try:
                last(params, cfg, ("flash", "ssd"))
            except RuntimeError as e:
                return f"FAIL ({str(e)[:90]})"
        worst = {}
        for name, r in calls:
            worst[name] = max(worst.get(name, 0.0), r)
        return "pass (" + ", ".join(f"{k} {v:.3e}" for k, v in
                                    worst.items()) + ")"

    for depth in args.depths:
        cfg = full.replace(n_layers=depth)
        for seed in args.seeds:
            params = registry.init(seed, cfg, device)
            p32 = T.tree_map(lambda x: x.float(), params)
            f32 = last(p32, cfg.replace(dtype=torch.float32))
            del p32
            plain = last(params, cfg)
            runs = {k: last(params, cfg, kern) for k, kern in (
                ("kernels", ("flash", "ssd")), ("flash", ("flash",)),
                ("ssd", ("ssd",)))}
            rel = {k: cs.rel_norm_err(x, plain) for k, x in runs.items()}
            print(f"depth {depth:2d} seed {seed}: plain vs f32 "
                  f"{cs.rel_norm_err(plain, f32):.3e}, kernels vs f32 "
                  f"{cs.rel_norm_err(runs['kernels'], f32):.3e}; against "
                  f"plain: kernels {rel['kernels']:.3e}, flash only "
                  f"{rel['flash']:.3e}, ssd only {rel['ssd']:.3e}",
                  flush=True)
            if depth == wiring_depth:
                line = [f"kernels {held(params, cfg)}"]
                line += [f"{c} {held(params, cfg, c)}" for c in controls]
                print(f"  seed {seed}, each kernel call against its plain "
                      "version on the model's inputs: " + "; ".join(line),
                      flush=True)
                with patched(layers, "blockwise_attention", sdpa_attention):
                    sdpa = cs.rel_norm_err(last(params, cfg), plain)
                line = [f"flash {verdict(rel['flash'])}",
                        f"sdpa {verdict(sdpa)}"]
                for c in ("flash_x2", "flash_x4", "flash_window"):
                    attr, make = controls[c]
                    with patched(ops, attr, make()):
                        line.append(f"{c} " + verdict(cs.rel_norm_err(
                            last(params, cfg, ("flash",)), plain)))
                print(f"  seed {seed}, logits with the flash kernel alone "
                      f"against plain (bound {bound}): " + ", ".join(line),
                      flush=True)
                line = [f"kernels {rel['kernels']:.3e}"]
                for c in ("flash_x4", "ssd_x4"):
                    attr, make = controls[c]
                    with patched(ops, attr, make()):
                        r = cs.rel_norm_err(
                            last(params, cfg, ("flash", "ssd")), plain)
                    line.append(f"{c} {r:.3e}")
                print(f"  seed {seed}, logits with both kernels against "
                      "plain (not held): " + ", ".join(line), flush=True)
            del params
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
