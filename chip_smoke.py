#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its
hand-written CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printed as it runs; any failed check raises and exits
non-zero before the result lines:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc builds the kernels from src/repro_torch/kernels/csrc;
  3. kernels against their plain versions on the card: the aggregation
     sweep and main-path shape (bit-equal), the flash-attention sweeps and
     main-path shape (2e-4/2e-5 f32, 2e-2/2e-2 bf16);
  4. wiring at full width, depth 2, f32: loss and pooled mean gradient with
     both kernels on equal the run with both off (loss rtol 1e-5, grads
     rtol 5e-4 / atol 1e-5);
  5. the main path: full-width olmo-1b in bf16, SMLT's Fig. 5 loop through
     LocalWorkerPool(n=4, scatter_reduce, bsp, use_kernel=True) with the
     flash kernel and AdamW, global batch 8 x 2048 tokens, 3 steps; the
     kernels' launch counts are checked;
  6. timing (CUDA events, median of 20) of each kernel, its plain version
     and one PyTorch library call at the main-path shapes, with its bound.

The second-to-last line is the {"kernels": [...]} record; the last is
{"ok": true, "device": {...}}. Needs one CUDA card; exits non-zero without.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
N_WORKERS = 4
GLOBAL_BATCH = 8
SEQ = 2048
STEPS = 3


def log(*a):
    print(*a, flush=True)


def require(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def require_close(got, want, rtol: float, atol: float, what: str) -> float:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = int((err > atol + rtol * w.abs()).sum())
    require(bool(g.isfinite().all()), f"{what}: non-finite values")
    require(bad == 0, f"{what}: {bad} elements outside rtol={rtol} "
            f"atol={atol} (max abs err {float(err.max()):.3e})")
    return float(err.max())


def tol(dtype):
    import torch
    return (2e-2, 2e-2) if dtype == torch.bfloat16 else (2e-4, 2e-5)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_aggregation(device, main_len: int, gen) -> float:
    import torch
    from repro_torch.kernels import hier_agg, ops
    for n in (1, 2, 8, 17):
        for length in (128, 1000, 8192, 20000):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(n, length, generator=gen,
                                device=device).to(dtype)
                got = ops.aggregate_shards(x, block=1024)
                want = hier_agg.plain_aggregate_shards(x)
                require(torch.equal(got, want),
                        f"aggregate n={n} L={length} {dtype}: not bit-equal "
                        f"(max abs err {max_err(got, want):.3e})")
    x = torch.randn(N_WORKERS, main_len, generator=gen, device=device)
    got = ops.aggregate_shards(x)
    want = hier_agg.plain_aggregate_shards(x)
    require(torch.equal(got, want), f"aggregate main shape ({N_WORKERS}, "
            f"{main_len}) f32: not bit-equal")
    err = max_err(got, want)
    log(f"  aggregation: 32 sweep cases + ({N_WORKERS}, {main_len}) f32 "
        f"bit-equal to the plain version")
    return err


def check_flash(device, main_shape, gen) -> float:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.layers import blockwise_attention

    def qkv(shape, dtype):
        return [torch.randn(*shape, generator=gen, device=device).to(dtype)
                for _ in range(3)]

    cases = 0
    for seq, block in ((128, 64), (160, 64), (256, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv((2, 3, seq, 64), dtype)
            got = ops.flash_attention(q, k, v, causal=True, block_q=block,
                                      block_k=block)
            want = fa.plain_flash_attention(q, k, v, causal=True)
            require_close(got, want, *tol(dtype),
                          f"flash causal seq={seq} block={block} {dtype}")
            cases += 1
    for window in (16, 64, 100):
        q, k, v = qkv((1, 2, 192, 32), torch.float32)
        got = ops.flash_attention(q, k, v, causal=True, window=window,
                                  block_q=64, block_k=64)
        want = fa.plain_flash_attention(q, k, v, causal=True, window=window)
        require_close(got, want, 2e-4, 2e-5, f"flash window={window}")
        cases += 1
    q, k, v = qkv((2, 2, 128, 32), torch.float32)
    got = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    want = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True).transpose(1, 2)
    require_close(got, want, 2e-4, 2e-5, "flash vs model blockwise")
    cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(main_shape, dtype)
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.plain_flash_attention(q, k, v, causal=True)
        err = require_close(got, want, *tol(dtype),
                            f"flash main shape {main_shape} {dtype}")
        cases += 1
    log(f"  flash: {cases} cases within tolerance; main shape "
        f"{main_shape} bf16 max abs err {err:.3e}")
    return err


# ---------------------------------------------------------------------------
# phases 4 and 5: the Fig. 5 loop through the port's entry points
# ---------------------------------------------------------------------------


def make_loader(cfg, seq: int):
    from repro_torch.data import DataConfig, ShardedLoader, TokenDataset
    return ShardedLoader(TokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                                 seq_len=seq)))


def pool_for(cfg, use_kernel: bool):
    from repro_torch.core import tree as T
    from repro_torch.models import registry
    from repro_torch.serverless import LocalWorkerPool, ParamStore
    grad_fn = T.grad(lambda p, b: registry.loss_fn(p, cfg, b))
    return LocalWorkerPool(grad_fn, N_WORKERS, ParamStore(),
                           plan="scatter_reduce", sync_mode="bsp",
                           use_kernel=use_kernel)


def check_wiring(cfg, device, batch_size: int, seq: int):
    """Loss and pooled mean gradient with both kernels on == both off."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.models import registry
    params = registry.init(0, cfg, device)
    batch = T.from_numpy(make_loader(cfg, seq).next_batch(batch_size), device)
    results = {}
    for on in (False, True):
        c = cfg.replace(use_flash_kernel=on)
        with torch.no_grad():
            loss = float(registry.loss_fn(params, c, batch))
        grads = pool_for(c, use_kernel=on).step(params, batch)
        results[on] = (loss, grads)
    (l0, g0), (l1, g1) = results[False], results[True]
    require(math.isfinite(l0) and abs(l1 - l0) <= 1e-5 * abs(l0),
            f"wiring loss: kernels on {l1!r} vs off {l0!r} (rtol 1e-5)")
    worst = 0.0
    for a, b in zip(T.leaves(g0), T.leaves(g1)):
        worst = max(worst, require_close(b, a, 5e-4, 1e-5, "wiring grads"))
    log(f"  wiring (d_model {cfg.d_model}, {cfg.n_layers} layers, f32): "
        f"loss off {l0!r} on {l1!r}; grads max abs err {worst:.3e}")


def run_main_path(cfg, device, batch_size: int, seq: int, steps: int):
    """Fig. 5 training loop; returns (losses, step seconds, launches)."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hier_agg
    from repro_torch.models import registry
    from repro_torch.optim import AdamW, warmup_cosine

    params = registry.init(0, cfg, device)
    opt = AdamW(lr=3e-4, schedule=warmup_cosine(2, 10))
    state = opt.init(params)
    pool = pool_for(cfg, use_kernel=True)
    loader = make_loader(cfg, seq)
    batches = [T.from_numpy(loader.next_batch(batch_size), device)
               for _ in range(steps)]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    fa.LAUNCHES = 0
    hier_agg.LAUNCHES = 0
    losses, step_s = [], []
    for batch in batches:
        with torch.no_grad():                      # one loss evaluation
            loss = registry.loss_fn(params, cfg, batch)
        sync()
        t0 = time.perf_counter()
        grads = pool.step(params, batch)
        params, state = opt.update(grads, state, params)
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        for p, g in zip(T.leaves(params), T.leaves(grads)):
            require(p.shape == g.shape and p.dtype == g.dtype,
                    "gradient tree does not match the params")
        del grads
    launches = {"flash_attention": fa.LAUNCHES,
                "aggregate_shards": hier_agg.LAUNCHES}
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for p in T.leaves(params):
        require(bool(p.float().isfinite().all()), "non-finite parameters")
    return losses, step_s, launches


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_kernels(device, main_len: int, main_shape, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hier_agg
    out = {}
    x = torch.randn(N_WORKERS, main_len, generator=gen, device=device)
    nbytes = (N_WORKERS + 1) * main_len * x.element_size()
    out["aggregate_shards"] = dict(
        ms=time_ms(lambda: hier_agg.aggregate_shards(x)),
        plain_ms=time_ms(lambda: hier_agg.plain_aggregate_shards(x)),
        library_ms=time_ms(lambda: x.mean(0, dtype=torch.float32)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    del x
    b, h, s, d = main_shape
    q, k, v = [torch.randn(*main_shape, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3)]
    flops = 4.0 * b * h * d * s * (s + 1) / 2   # the pairs the mask leaves
    io = 4 * q.numel() * q.element_size()
    out["flash_attention"] = dict(
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: fa.plain_flash_attention(q, k, v,
                                                          causal=True)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        bound_ms=max(flops / BF16_FLOPS_PER_S, io / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOPS_PER_S
        >= io / HBM_BYTES_PER_S else "bytes")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.models import registry

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
        "allow_tf32 matmul=False cudnn=False")

    _build.load()
    info = _build.build_info()
    log(f"[2] build: {info['path']} in {info['seconds']:.1f} s")
    log("\n".join(line for line in info["log"].splitlines()
                  if any(w in line for w in ("Compiling entry", "registers",
                                             "spill", "=="))))

    full = ARCHS["olmo-1b"]
    n_params = registry.param_count(full)
    flat_len = -(-n_params // N_WORKERS)            # one worker's shard
    main_shape = (GLOBAL_BATCH // N_WORKERS, full.n_heads, SEQ,
                  full.resolved_head_dim)
    gen = torch.Generator(device=device).manual_seed(0)
    log(f"[3] kernels vs plain versions (olmo-1b: {n_params} params, "
        f"shard length {flat_len})")
    agg_err = check_aggregation(device, flat_len, gen)
    flash_err = check_flash(device, main_shape, gen)
    torch.cuda.empty_cache()

    log("[4] wiring at full width, depth 2, f32")
    check_wiring(full.replace(n_layers=2, dtype=torch.float32), device,
                 GLOBAL_BATCH, SEQ)
    torch.cuda.empty_cache()

    cfg = full.replace(use_flash_kernel=True)
    log(f"[5] main path: {cfg.arch_id} {cfg.n_layers} layers d_model "
        f"{cfg.d_model} bf16, {N_WORKERS} workers scatter_reduce bsp, "
        f"batch {GLOBAL_BATCH} x {SEQ}, {STEPS} steps, AdamW")
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, launches = run_main_path(cfg, device, GLOBAL_BATCH, SEQ,
                                             STEPS)
    peak = torch.cuda.max_memory_allocated()
    tokens = GLOBAL_BATCH * SEQ
    log(f"  losses {losses}")
    log(f"  step seconds {step_s}; tokens/s "
        f"{[tokens / t for t in step_s]}; peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    want = {"flash_attention": cfg.n_layers * N_WORKERS * STEPS
            + cfg.n_layers * STEPS,
            "aggregate_shards": N_WORKERS * STEPS}
    log(f"  launches {launches}, expected {want}")
    require(launches == want, f"launch counts {launches} != {want}")
    torch.cuda.empty_cache()

    log("[6] timing (CUDA events, median of 20)")
    times = time_kernels(device, flat_len, main_shape, gen)
    for name, t in times.items():
        log(f"  {name}: {t}")

    kernels = [
        dict(name="aggregate_shards", route="cuda",
             source="src/repro_torch/kernels/csrc/hier_agg.cu",
             replaces="src/repro/kernels/hier_agg.py:24",
             launches=launches["aggregate_shards"], max_abs_err=agg_err,
             **times["aggregate_shards"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:26",
             launches=launches["flash_attention"], max_abs_err=flash_err,
             **times["flash_attention"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
