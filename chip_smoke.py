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
     main-path shape (2e-4/2e-5 f32 on the CUDA-core route, 2e-2/2e-2 bf16
     on the tensor-core route): bf16 windows {16, 64, 100} causal and not,
     and the main shape, on the model's transposed (b, s, h, d) views,
     each bf16 view case also within a relative norm error
     (FLASH_BF16_REL_NORM);
  4. wiring at full width, depth 2, f32: loss and pooled mean gradient with
     both kernels on equal the run with both off (loss rtol 1e-5, grads
     rtol 5e-4 / atol 1e-5), each worker's gradient through the CUDA-core
     flash backward;
  5. the main path: full-width olmo-1b in bf16, SMLT's Fig. 5 loop through
     LocalWorkerPool(n=4, scatter_reduce, bsp, use_kernel=True) with the
     flash kernel and AdamW, global batch 8 x 2048 tokens, 3 steps; the
     kernels' launch counts are checked, the flash backward's too (one for
     each forward with a gradient: 16 x 4 x 3, all on wgmma);
  6. timing (CUDA events around 20 calls back to back, median of 5
     batches) of each kernel, its plain version
     and one PyTorch library call at the main-path shapes, with its bound,
     and of each kernel's call timed alone (call_ms: the host's enqueue
     included, as PERF.md's earlier per-call times were taken);
     the flash kernel on the model's views, with its achieved TFLOP/s and
     its share of the bound; the aggregation beside a plain device copy;
  7. the SSD scan and aggregate_and_apply against their plain versions on
     the card: the reference's sweeps on whichever route each case takes
     (SSD f32 2e-4 on y and the state, bf16 5e-2 on y and 1e-2 on the
     state; apply rtol 1e-5 / atol 1e-6); a bf16 sweep on the tensor-core
     route (one case padded); slow-decay cases that carry the state across
     chunks, on both routes; the scoring shape of mamba2-2.7b with the
     model's dtypes and B / C views, on both routes; the tensor-core
     route's y also within a relative norm error (SSD_BF16_REL_NORM); and
     aggregate_and_apply at olmo-1b's shard length;
  8. SSM wiring at full width, depth 2: in f32, the loss with the SSD
     kernel equals the loss without it (rtol 1e-4); on the last position's
     logits, prefill (plain chunked SSD) equals the kernel forward (rtol
     1e-4 / atol 1e-4), and decode after prefill (the per-token
     recurrence) equals prefill at the reference's sequential-vs-chunked
     SSD tolerance (rtol 3e-4 / atol 3e-4, tests/test_models_ref.py:49-52);
     in bf16 (the tensor-core route), the loss and the last position's
     logits with the kernel against the plain ssd_chunked path
     (SSM_BF16_LOSS_RTOL, SSM_BF16_LOGITS_REL_NORM);
  9. the second slice, full-width mamba2-2.7b in bf16 (64 layers, random
     weights from seed 0): scoring, 3 evaluations of registry.loss_fn
     through the SSD kernel on 8 x 2048 tokens (exactly 64 x 3 launches,
     all on the tensor-core route), then serving,
     ServingEngine.serve_batch on 4 prompts of 2048 tokens with 32 new
     tokens each (the prefill from the zero state through the SSD kernel:
     exactly 64 launches); then the same requests served again with every
     SSD call of the prefill held against its plain version
     (held_against_plain);
 10. timing of the SSD scan (both routes at the scoring shape, each with
     its achieved TFLOP/s on its own FLOP count and its share of the
     bound) and aggregate_and_apply as in phase 6;
 11. the fifth slice's kernel shapes against the plain versions: flash at
     zamba2-7b's head dim 112 on both routes, causal with windows
     {0, 64, 4096} at s in {256, 8192} on the model's views (f32
     2e-4/2e-5; bf16 2e-2/2e-2 and FLASH_BF16_REL_NORM); the bf16 route at
     the shapes the models launch it with, zamba2-7b's (4, 32, 4096, 112)
     with window 4096 and qwen2-moe-a2.7b's (8, 16, 2048, 128), at the same
     bf16 tolerances; the SSD scan at zamba2-7b's scoring shape on both
     routes (as phase 7);
 12. hybrid and MoE wiring at full width, reduced depth: zamba2-7b at
     depth 7 (one shared-block site and one remainder layer), the loss
     with the flash and SSD kernels on against off, f32 (rtol 1e-4) and
     bf16 (SSM_BF16_LOSS_RTOL; the last position's logits with the flash
     kernel alone within HYBRID_FLASH_LOGITS_REL_NORM of the plain
     path's); qwen2-moe-a2.7b at depth 2 in f32, flash on against off
     (rtol 1e-5); in each, every kernel call is also held against its
     plain version on the model's own inputs (phase 3's and 7's
     tolerances, and in bf16 FLASH_BF16_REL_NORM and SSD_BF16_REL_NORM);
 13. zamba2-7b at full width in bf16 (81 layers, 13 shared-block sites,
     random weights from seed 0, both kernels): 3 scoring evaluations on
     4 x 4096 tokens (exactly 13 x 3 flash and 81 x 3 SSD launches, all on
     the tensor cores), then serving 4 prompts of 4096 tokens with 32 new
     tokens each (the first decode step writes ring slot 0: the window's
     ring wraps; the prefill's 81 SSD layers through the kernel); then the
     same requests again with every kernel call of the prefill held
     against its plain version, as in phase 9;
 14. qwen2-moe-a2.7b at full width in bf16 (24 layers, 60 routed experts
     top-4 and 4 shared, seed 0, the flash kernel): 3 scoring evaluations
     on 8 x 2048 tokens (exactly 24 x 3 flash launches, all on the tensor
     cores), then serving 4 prompts of 2048 tokens, 32 new tokens each;
 15. timing as in phases 6 and 10: flash at zamba2-7b's (4, 32, 4096, 112)
     with window 4096 and qwen2-moe-a2.7b's (8, 16, 2048, 128), the SSD
     scan at zamba2-7b's (4, 4096, 112, 64), n 64;
 16. the sixth slice's wiring, olmo-1b at full width, depth 2, f32: one
     make_train_step("hier") step at world size 1 (NCCL) equals
     registry.loss_fn and AdamW.update called directly (loss rtol 1e-5,
     params rtol 5e-4 / atol 1e-5), with the flash kernel on and off; flash
     on against off, and remat "full" and "dots" against remat off, on the
     loss (rtol 1e-5) and gradient (rtol 5e-4 / atol 1e-5), with exact
     flash launch counts, forward and backward (remat's recompute runs the
     forward again, not the backward);
 17. the sixth slice's main path: full-width olmo-1b in bf16 trained through
     launch/train.py::train with the hier step (reduce-scatter, AdamW on
     the shards, all-gather) at world size 1, the flash kernel, batch 8 x
     2048, 5 steps; losses finite, exactly 16 x 5 flash launches and as
     many of its backward, all on the tensor cores; step seconds, tokens/s and peak memory beside phase
     5's pool step (the flash kernel at this (8, 16, 2048, 128) shape is
     phase 15's qwen2-moe row);
 18. the port's examples/train_e2e.py at its default size (35,660,288
     params, f32, 300 steps, the batch doubling at 100, the checkpoint
     cycle at 150 through a DiskCheckpointer in a temporary directory):
     the restored state is bit-equal to the saved one and the loss falls
     by more than 0.5; then its serverless projection (the event engine,
     as the reference's default);
 19. the seventh slice's flash shapes against the plain version (phase 11's
     check_flash_shapes, bf16): the decoders' self-attention of
     seamless-m4t-medium, (8, 16, 2048, 64), and of llama-3.2-vision-90b,
     (4, 64, 2048, 128), causal, on the model's views;
 20. vlm and audio wiring at full width, reduced depth, f32: seamless with
     2 encoder and 2 decoder layers, llama-vision at depth 5 (one group of
     4 self layers and a cross layer, its tanh gates opened to XATTN_GATE:
     they are zero at init, which would hide the cross layer); the loss
     with the flash kernel on against off (rtol 1e-5), every flash call
     held against its plain version on the model's inputs, exact launch
     counts (decoder self-attention only: never the encoder or the cross
     layers); prefill's last-position logits against the loss forward's
     (rtol 1e-4 / atol 1e-4); teacher-forced decode after a half prefill
     against prefill, 3 steps (rtol 2e-2 / atol 2e-3,
     tests/test_arch_smoke.py:57-74), with no flash launch;
 21. seamless-m4t-medium at full width (nothing cut) and
     llama-3.2-vision-90b at full width cut to VISION_DEPTH layers, bf16,
     seed-0 weights, the flash kernel: 3 scoring evaluations with numpy-
     seeded modality inputs (seamless 8 x 2048 tokens and 512 audio
     frames, exactly 12 x 3 flash launches; llama 4 x 2048 tokens and 1600
     image tokens, exactly 16 x 3), every flash call of the first held
     against its plain version; then serving 4 prompts of 2048, 32 new
     tokens, through ServingEngine and its zero modality stubs (no flash
     launch: prefill attends through the KV cache); peaks under 80 GB;
 22. timing as in phase 6: flash at the two shapes of phase 19;
 23. the serverless projection of phase 17's run (train_e2e's
     serverless_projection: full-width olmo-1b, 8 x 2048, 5 steps, as a
     Workload on 16 x 4096 MB Lambda workers, hier, bsp and async,
     straggler sigma 0.3, seed 0): each mode completes an iteration with
     finite simulated wall seconds and dollars and at least 16
     invocations; the simulated events and the host's events/s;
 24. the port's examples/quickstart.py on the card: reduced olmo-1b
     trained 40 steps through launch/train.py (hier), the scheduler's
     Scenario 1 (its deployments, wall <= 3600 s), and the CUDA
     aggregate_shards kernel against its plain version at (8, 4096) f32
     (rtol/atol 1e-6); exactly one aggregate_shards launch and no other;
 25. the golden engine trace (resnet18, hier, 2 workers, 2048 MB, batch
     512, 1024 samples, sigma 0.3, seed 42) built from the port, twice:
     byte for byte tests/golden_engine_trace.txt;
 26. the port's examples/deadline_budget.py with its defaults (bert-medium,
     25,000 samples, 6 epochs, deadline 3600 s, budget $50, seed 0):
     Scenario 3, a train -> fine-tune -> eval workflow under one goal on
     the analytic engine; each task's window, epochs, workers, dollars
     and grant, the workflow's wall and ledger equal the JAX package's
     (SCENARIO3, exact), both goals met;
 27. the golden workflow trace (tools/golden_workflow_trace.py: an
     8-trial, 2-rung successive-halving sweep and a fine-tune, then a
     train -> eval -> deploy -> online_update DAG whose deploy is a
     ServingJob, both on the event engine) built from the port, each
     workflow twice: byte for byte tests/golden_workflow_trace.txt, the
     sweep's wall, ledger and winner equal the JAX package's (HPO_GOLDEN);
 28. the port's simlint over src/repro_torch: no finding; the known-bad
     determinism fixture copied under repro_torch/serverless and
     repro_torch/workflow fires det-raw-randomstate and det-set-iter on
     the original's lines;
 29. the ZeRO-3 step at full width: phase 17's run (olmo-1b, bf16, 8 x
     2048, 5 steps through launch/train.py::train, world size 1 on NCCL)
     with make_train_step(fsdp=True): losses equal phase 17's at rtol
     1e-5, exactly 16 x 5 flash launches and 16 x 5 backward, all on
     wgmma; step seconds,
     tokens/s and peak beside phase 17's;
 30. the dry run held against the card: launch/dryrun.py's lower_one for
     full-width olmo-1b (hier, fsdp=True, remat, the flash kernel) on a
     one-rank mesh at 8 x 2048 train, on fake CUDA tensors; then the same
     step run for real under FlopCounterMode: the predicted FLOPs equal
     the measured ones exactly, and the predicted peak lies within
     DRYRUN_PEAK_RTOL of max_memory_allocated; then olmo-1b train_4k,
     mistral-large-123b decode_32k, zamba2-7b long_500k and arctic-480b
     train_4k traced on the 256-rank production mesh (fake process
     group, fake CUDA tensors), each one's terms and trace seconds
     (per-rank predictions, not card measurements); then full-width
     mamba2-2.7b's prefill step (the SSD kernel on) at PREFILL_BATCH x
     PREFILL_SEQ on a one-rank mesh, traced and run: the predicted FLOPs
     equal the measured ones, smlt::ssd_scan's among them (ssd_flops, one
     call a layer, all on wgmma); the step run again with each SSD call
     held against plain_ssd_scan (held_against_plain: the state at
     ssd_tol, y within SSD_BF16_REL_NORM), its logits equal to the counted
     run's; and registry.prefill at that shape
     timed on each path, the SSD kernel and ssd_chunked (host clock
     around a synchronised call, median of PREFILL_TIMED after a warm-up);
 31. the prefill and serve steps at full width: olmo-1b in bf16 through
     make_prefill_step and make_serve_step (fsdp=True) over a one-rank
     mesh, 4 prompts of 2048 then 32 greedy tokens: the tokens equal
     ServingEngine's (phase 13's path) on the same prompts and weights;
     prefill seconds and decode ms per token per request beside the
     engine's;
 32. tensor parallelism (a model axis of TP_RANKS = 2, "1x2"), each rank
     a process of this script (``--tp-rank``) on the one card, joined
     through gloo (NCCL refuses two ranks on one device), under one
     deadline that kills every rank: full-width olmo-1b in bf16 trained
     through launch/train.py::train with the hier step, batch 2 x 2048
     (cut from 8 so that both ranks fit), 3 steps, against the same steps
     at world size 1 on the same batches (first loss within 2e-3, later
     ones within 1e-2, relative); exactly 16 x 3 flash launches a rank,
     all on wgmma, at (2, 8, 2048, 128); each rank's peak; rank 0's
     FlopCounterMode FLOPs of the step equal to launch/dryrun.py's
     lower_one on "1x2" (phase 30's equality on a model axis);
 33. the prefill and serve steps on "1x2", olmo-1b in f32 and in bf16,
     4 prompts of 2048 then 8 teacher-forced tokens, against the same
     steps at world size 1: the last position's logits of every step in
     f32 within 1e-2 (relative norm); in bf16 no further from the f32
     logits than TP_BF16_NOISE_RATIO times the unsplit bf16 program's
     distance from them; the greedy tokens' agreement printed;
 34. scoring on "1x2": qwen2-moe-a2.7b (60 experts, 30 a rank, expert
     parallel) and mamba2-2.7b (80 SSD heads, 40 a rank) at full width in
     bf16, batch 4 x 2048, 2 evaluations, the first with every kernel
     call held against its plain version (phase 12's tolerances); losses
     within 1e-3 of world size 1's; exact launch counts, all on wgmma, at
     the local shapes (4, 8, 2048, 128) and (4, 2048, 40, 64); those
     shapes then held against their plain versions and timed as in phase
     6. Times in phases 32-37 are of 2 ranks sharing one card through
     gloo, not tensor-parallel speed;
 35. scoring on "1x2" in bf16, seed 0, against world size 1: zamba2-7b
     (4 x 4096; 16 of 32 heads and 56 of 112 SSD heads a rank),
     llama-3.2-vision-90b cut to VISION_DEPTH layers (4 x 2048, 1600
     image tokens, its gates opened to XATTN_GATE on both sides; the
     cross K/V on 4 of 8 KV heads a rank), seamless-m4t-medium (8 x 2048,
     512 frames), 2 evaluations, the first with every kernel call held
     against its plain version; losses within 1e-3 of world size 1's;
     exactly 13 flash + 81 SSD, 16 and 12 flash launches a rank per
     evaluation, all on wgmma, at the local shapes (4, 16, 4096, 112),
     (4, 4096, 56, 64), (4, 32, 2048, 128), (8, 8, 2048, 64); the weights
     are cut to each rank's parts leaf by leaf (shard_leafwise), so that
     llama-vision's 38.4 GB fit beside the other rank's half;
 36. the prefill and serve steps of the three on "1x2" in f32 against
     world size 1 (zamba2 4 prompts of 4096 then 8 teacher-forced tokens,
     so that its 4096-slot rings wrap; seamless, and llama-vision at
     depth 5, 4 prompts of 2048): last-position logits within 1e-2 (relative
     norm) at every step, greedy tokens' agreement printed, each rank's
     cache half of every split leaf (ring, image_kv, cross_kv, SSM
     state); no kernel launch;
 37. phase 32 under seq_shard (the stream split along the sequence between
     the layers): losses against phase 32's world size 1 at its
     tolerances, exact launches at (2, 8, 2048, 128); rank 0's FLOPs and
     collectives equal lower_one's on "1x2" with seq_shard, and the
     model group's per-layer all-reduces replaced by reduce-scatter /
     all-gather pairs against phase 32's step; each rank's peak beside
     phase 32's (olmo-1b's norms carry no scale, so no whole leaf is
     read on the slice there);
 37b. zamba2-7b at full width, 6 Mamba2 layers and the shared block, f32
     without the kernels, batch 2 x 2048, under seq_shard on "1x2": the
     first gradient of every leaf a rank holds whole (norm scales, wB,
     wC, conv_BC; read on the slice, their partial gradients summed over
     the model group) within 1e-3 (relative norm) of world size 1's, then
     3 hier steps' losses within 1e-3; then the local shapes of phase 35
     held against their plain versions and timed as in phase 6.
 38. the flash backward (csrc/flash_attention_bwd.cu) against
     plain_flash_attention_bwd: phase 3's sweep for every head dim (32, 64,
     112, 128) on both routes (f32 rtol 5e-4 / atol 1e-5; bf16 2e-2 / 2e-2
     and each of dq, dk, dv within FLASH_BWD_BF16_REL_NORM), the forward's
     lse against plain_flash_lse, one padded length through
     ops.flash_attention's autograd; bf16 at the training shapes (2, 16,
     2048, 128), (8, 16, 2048, 128), (2, 8, 2048, 128) and zamba2's (4, 32,
     4096, 112) window 4096, two calls bit-equal; then each timed as in
     phase 6 beside its plain version, the library's flash backward and
     its bound. Phases 30, 32 and 37 also check the backward's launches
     exactly (16 under remat against 32 forwards; 16 x 3 a rank).
 39. AdamW's kernels (csrc/adamw.cu) at olmo-1b's tree with the tied head
     (8 leaves, the 16 layers stacked, bf16 parameters and gradients, f32
     moments): every leaf's update against plain_adamw_update (new
     parameters, m and v bit-equal) and its sum of squares against
     plain_sum_squares (1e-6 relative, two calls bit-equal), then the
     whole tree's update and sum of squares timed as in phase 6 beside
     the plain versions, the library's multi-tensor kernels
     (torch._fused_adamw_ in f32, torch._foreach_norm; timed only) and the
     byte bound (22 + 2 bytes a parameter), and one AdamW.update over the
     tree: one call of each kernel a leaf. The training phases (5, 17, 24,
     29, 30, 32, 37, 37b) count both kernels' calls in their launch checks:
     steps times leaves.
 40. granite-4.0-h-small (the benchmark's hybrid MoE cell: the
     configuration file perfbench/configs/granite-4.0-h-small.json, 40
     layers at full width, 36 of 72 experts held, bf16, random weights
     from seed 0) scored on the cell's 8 x 4096 tokens through
     registry.loss_fn: the first evaluation with every flash, SSD and
     grouped expert products call held against its plain version
     (held_against_plain; the products within EXPERTS_REL_NORM of the
     per-expert plain products); its 4 flash calls at (8, 32, 4096, 128)
     with scale 1/128 and its 36 SSD calls at 128 heads x 4096 (head 64,
     state 128, chunk 256), exactly 4 flash and 36 SSD launches an
     evaluation, all on wgmma; then SCORE_EVALS evaluations timed, and
     one with spans on whose counters read 40 layers' held pairs and no
     pair dropped; peak memory under 80 GB.
 41. the serving engine's decode step replayed as one captured CUDA graph
     (serving/engine.py::DecodeGraph): full-width mamba2-2.7b (bf16,
     random weights from seed 0) at batch 8, one batch of each of the
     serve cell's prompt lengths (256, 512, 1024, 2048) with 32 greedy
     tokens through the graphed engine and through the eager loop on the
     same weights: tokens equal; each path's milliseconds a decode step;
     the counters serve.decode_replayed (31 a batch) and
     serve.decode_eager (none); peak memory.

The second-to-last line is the {"kernels": [...]} record; the last is
{"ok": true, "device": {...}}. Needs one CUDA card; exits non-zero without.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
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
TRAIN_STEPS = 5              # phase 17: launch/train.py with the hier step
SCORE_EVALS = 3
SERVE_REQUESTS = 4
SERVE_NEW_TOKENS = 32
LR = 0.05
# ||got - want|| / ||want|| of the bf16 flash route against its plain
# version, about twice what it measures on an H100 (2.0e-3 to 2.3e-3: P
# is rounded to bf16 for P V); the elementwise 2e-2 alone admits an error
# confined to the late rows, where outputs are a few 1e-2
FLASH_BF16_REL_NORM = 5e-3
# ||y - y_plain|| / ||y_plain|| of the tensor-core SSD route, about twice
# what its split-bf16 arithmetic gives, emulated at the scoring widths
# (tests/test_torch_ssd_numerics.py: 5.2e-5 to 1.04e-4)
SSD_BF16_REL_NORM = 2.5e-4
# the depth-2 bf16 SSM wiring check (phase 8): the kernel path and the
# plain ssd_chunked path differ by the kernel's split-bf16 products and y's
# rounding (relative norm ~1e-4 per layer), which the bf16 layers after it
# round again: the loss is a mean over 16,384 tokens, held to rtol 1e-3;
# the last position's logits to a relative norm error of 1e-2
SSM_BF16_LOSS_RTOL = 1e-3
SSM_BF16_LOGITS_REL_NORM = 1e-2
# the bf16 hybrid wiring check (phase 12), zamba2-7b at depth 7: the last
# position's logits with the flash kernel alone on against the plain path
# read 4.3e-3 to 4.7e-3 over seeds 0-2 (SDPA in its place reads the same;
# the window cut to a quarter 2.2e-2). With both kernels on they lie
# 1.9e-2 to 3.8e-2 apart, and scaling either kernel's own error by 4 does
# not move that: the random-weight Mamba2 layers amplify every bf16
# rounding, the plain path's own as much (tools/probe_hybrid_bf16.py on an
# H100 80GB HBM3 at 700 W). So every kernel call is held against its
# plain version on the model's inputs (held_against_plain), and the logits
# only where the SSD layers run the same code on both paths
HYBRID_FLASH_LOGITS_REL_NORM = 1e-2
# the fifth slice's cells: zamba2-7b scored on 4 x 4096 tokens (Zamba2's
# 4k context; the 16,384 tokens an evaluation of phase 9) and served
# 4 prompts of 4096; qwen2-moe-a2.7b on phase 9's 8 x 2048 and 4 x 2048
HYBRID_BATCH, HYBRID_SEQ = 4, 4096
# the seventh slice's cells: seamless-m4t-medium scored on phase 9's
# 8 x 2048 tokens, llama-3.2-vision-90b on 4 x 2048 at 20 of its 100
# layers (4 groups of 4 self layers and a cross layer: 19.2 B params,
# 38.4 GB in bf16; the full model's 175 GB fit no card); both served
# 4 prompts of 2048
VISION_DEPTH = 20
VISION_BATCH = 4
# the vlm wiring opens the cross layers' tanh gates, which are zero at init
XATTN_GATE = 0.5
# phase 40: the benchmark's granite-4.0-h-small configuration at the
# cell's batch; its parameters held (36 of 72 experts a layer)
GRANITE_CONFIG = ROOT / "perfbench" / "configs" / "granite-4.0-h-small.json"
GRANITE_BATCH, GRANITE_SEQ = 8, 4096
GRANITE_PARAMS = 18_617_793_024
# ||got - want|| / ||want|| of the grouped expert products against the
# plain per-expert products on the same rows, as the card test holds them
# (tests/test_torch_cuda.py): both round the first product to bf16, so
# they differ by the products' accumulation order
EXPERTS_REL_NORM = 5e-3
# phase 41: the serve cell's batch, prompt lengths and greedy tokens
DECODE_GRAPH_BATCH = 8
DECODE_GRAPH_LENS = (256, 512, 1024, 2048)
DECODE_GRAPH_TOKENS = 32
# phase 30: the dry run's predicted peak against max_memory_allocated
DRYRUN_PEAK_RTOL = 0.15
# phase 30: mamba2-2.7b's prefill step, the prefill-long cell's batch
PREFILL_BATCH, PREFILL_SEQ = 8, 4096
PREFILL_TIMED = 3
# phase 30: the remat step against the same step with remat off (the
# ZeRO-3 gather inside the checkpoint, again in the backward). The f32
# first moments, (1 - b1) times the clipped gradient, hold the gradients
# leaf by leaf; the bf16 parameters the whole update, whose Adam first
# step is lr times the gradient's sign, so a gradient within rounding of
# zero may flip one element
REMAT_MU_REL_NORM = 1e-3
REMAT_UPDATE_REL_NORM = 1e-2
# phase 30's traces on the 256-rank production mesh
PRODUCTION_TRACES = (("olmo-1b", "train_4k"), ("mistral-large-123b",
                                               "decode_32k"),
                     ("zamba2-7b", "long_500k"), ("arctic-480b", "train_4k"))


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


def rel_norm_err(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


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


def bshd_views(shape, dtype, gen, device):
    """Three (b, h, s, d) views of (b, s, h, d) memory, as the model's
    attention hands them to the kernel."""
    import torch
    b, h, s, d = shape
    return [torch.randn(b, s, h, d, generator=gen, device=device).to(dtype)
            .transpose(1, 2) for _ in range(3)]


def check_flash(device, main_shape, gen) -> float:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.layers import blockwise_attention

    def qkv(shape, dtype):
        return [torch.randn(*shape, generator=gen, device=device).to(dtype)
                for _ in range(3)]

    routes = dict(fa.ROUTE_LAUNCHES)
    bf16_calls = 0
    rels = []                      # relative norm errors of the bf16 views

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
            bf16_calls += dtype == torch.bfloat16
    for window in (16, 64, 100):
        q, k, v = qkv((1, 2, 192, 32), torch.float32)
        got = ops.flash_attention(q, k, v, causal=True, window=window,
                                  block_q=64, block_k=64)
        want = fa.plain_flash_attention(q, k, v, causal=True, window=window)
        require_close(got, want, 2e-4, 2e-5, f"flash window={window}")
        cases += 1
        for causal in (True, False):
            q, k, v = bshd_views((2, 4, 384, 128), torch.bfloat16, gen,
                                 device)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.plain_flash_attention(q, k, v, causal=causal,
                                            window=window)
            what = (f"flash bf16 window={window} causal={causal} on "
                    "(b, s, h, d) views")
            require_close(got, want, 2e-2, 2e-2, what)
            rels.append(rel_norm_err(got, want))
            require(rels[-1] < FLASH_BF16_REL_NORM, f"{what}: relative "
                    f"norm error {rels[-1]:.3e} >= {FLASH_BF16_REL_NORM}")
            cases += 1
            bf16_calls += 1
    q, k, v = qkv((2, 2, 128, 32), torch.float32)
    got = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    want = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True).transpose(1, 2)
    require_close(got, want, 2e-4, 2e-5, "flash vs model blockwise")
    cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = bshd_views(main_shape, dtype, gen, device)
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.plain_flash_attention(q, k, v, causal=True)
        what = f"flash main shape {main_shape} {dtype} on (b, s, h, d) views"
        err = require_close(got, want, *tol(dtype), what)
        if dtype == torch.bfloat16:
            rels.append(rel_norm_err(got, want))
            require(rels[-1] < FLASH_BF16_REL_NORM, f"{what}: relative "
                    f"norm error {rels[-1]:.3e} >= {FLASH_BF16_REL_NORM}")
        require(device.type == "cpu" or got.transpose(1, 2).is_contiguous(),
                "flash output not in (b, s, h, d) memory")
        cases += 1
        bf16_calls += dtype == torch.bfloat16
    new = {r: n - routes[r] for r, n in fa.ROUTE_LAUNCHES.items()}
    if device.type == "cuda":              # a CPU rehearsal launches nothing
        require(new == {"wgmma": bf16_calls,
                        "cuda_cores": cases - bf16_calls},
                f"flash routes {new}: want every bf16 case ({bf16_calls}) "
                "on wgmma and every f32 case on the CUDA cores")
    log(f"  flash: {cases} cases within tolerance (routes {new}); main "
        f"shape {main_shape} bf16 on (b, s, h, d) views max abs err "
        f"{err:.3e}, relative norm err {rels[-1]:.3e} (bf16 views: "
        f"{', '.join(f'{r:.3e}' for r in rels)}; limit "
        f"{FLASH_BF16_REL_NORM})")
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
    from repro_torch.kernels import flash_attention as fa
    params = registry.init(0, cfg, device)
    batch = T.from_numpy(make_loader(cfg, seq).next_batch(batch_size), device)
    results = {}
    zero_counts()
    for on in (False, True):
        c = cfg.replace(use_flash_kernel=on)
        with torch.no_grad():
            loss = float(registry.loss_fn(params, c, batch))
        grads = pool_for(c, use_kernel=on).step(params, batch)
        results[on] = (loss, grads)
    (l0, g0), (l1, g1) = results[False], results[True]
    # each worker's gradient through the CUDA-core backward
    bwd = fa.BWD_ROUTE_LAUNCHES
    require(device.type == "cpu" or bwd == {
        "wgmma": 0, "cuda_cores": N_WORKERS * cfg.n_layers},
        f"f32 wiring's flash backward routes {bwd}: want "
        f"{N_WORKERS * cfg.n_layers} on the CUDA cores")
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
    zero_counts()
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
    launches = kernel_counts()
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for p in T.leaves(params):
        require(bool(p.float().isfinite().all()), "non-finite parameters")
    return losses, step_s, launches


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------


def time_ms(fn, runs: int = 20, warmup: int = 3, batches: int = 5) -> float:
    """Milliseconds a call: CUDA events around `runs` calls back to back
    (the host enqueues the next call while the card runs this one), the
    median over `batches` such runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(runs):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / runs)
    return statistics.median(times)


def call_ms(fn, runs: int = 20) -> float:
    """Milliseconds a call timed alone: the median of CUDA events around
    each of `runs` calls, so the host's enqueue of the call (the wrapper,
    ctypes, TMA descriptors) is in the window when it exceeds the card's
    time. PERF.md's earlier per-call times were taken so."""
    return time_ms(fn, runs=1, batches=runs)


def time_kernels(device, main_len: int, main_shape, gen):
    import torch
    from repro_torch.kernels import hier_agg
    out = {}
    x = torch.randn(N_WORKERS, main_len, generator=gen, device=device)
    nbytes = (N_WORKERS + 1) * main_len * x.element_size()
    out["aggregate_shards"] = dict(
        ms=time_ms(lambda: hier_agg.aggregate_shards(x)),
        call_ms=call_ms(lambda: hier_agg.aggregate_shards(x)),
        plain_ms=time_ms(lambda: hier_agg.plain_aggregate_shards(x)),
        library_ms=time_ms(lambda: x.mean(0, dtype=torch.float32)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    dst = torch.empty_like(x)
    copy_ms = time_ms(lambda: dst.copy_(x))          # reads and writes n*L
    agg = out["aggregate_shards"]
    log(f"  aggregate_shards moves {nbytes} bytes: "
        f"{nbytes / agg['ms'] / 1e6:.1f} GB/s; a device-to-device copy of "
        f"the {x.numel() * x.element_size()} input bytes takes {copy_ms:.4f} "
        f"ms, {2 * x.numel() * x.element_size() / copy_ms / 1e6:.1f} GB/s")
    del x, dst
    out["flash_attention"] = time_flash(device, main_shape, gen)
    return out


def time_flash(device, shape, gen, window: int = 0):
    """The bf16 flash kernel on the model's transposed (b, s, h, d) views,
    causal with ``window``, against its plain version and SDPA (the same
    function where the window does not bite), with its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, h, s, d = shape
    q, k, v = bshd_views(shape, torch.bfloat16, gen, device)
    # the (query, key) pairs the causal mask and the window leave
    w = window if 0 < window < s else s
    pairs = w * (w + 1) / 2 + (s - w) * w
    flops = 4.0 * b * h * d * pairs
    io = 4 * q.numel() * q.element_size()
    f = dict(
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                              window=window)),
        call_ms=call_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                                   window=window)),
        plain_ms=time_ms(lambda: fa.plain_flash_attention(
            q, k, v, causal=True, window=window)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)) if w == s else None,
        bound_ms=max(flops / BF16_FLOPS_PER_S, io / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOPS_PER_S
        >= io / HBM_BYTES_PER_S else "bytes")
    sdpa = f" {f['ms'] / f['library_ms']:.2f}x SDPA;" if f["library_ms"] \
        else ""
    log(f"  flash_attention ({fa.flash_route(q.dtype, d)}) at {shape} "
        f"bf16 causal{f' window {window}' if window else ''}: "
        f"{flops / f['ms'] / 1e9:.1f} TFLOP/s, "
        f"{f['bound_ms'] / f['ms']:.3f} of its bound,{sdpa} "
        f"{f['call_ms']:.4f} ms a call timed alone")
    return f


# ---------------------------------------------------------------------------
# phase 7: the second slice's kernels against their plain versions
# ---------------------------------------------------------------------------


def check_agg_apply(device, main_len: int, gen) -> float:
    import torch
    from repro_torch.kernels import hier_agg, ops
    for length in (512, 5000):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(N_WORKERS, length, generator=gen,
                            device=device).to(dtype)
            p = torch.randn(length, generator=gen, device=device).to(dtype)
            got = ops.aggregate_and_apply(x, p, lr=LR)
            want = hier_agg.plain_aggregate_and_apply(x, p, LR)
            require_close(got, want, 1e-5, 1e-6,
                          f"aggregate_and_apply L={length} {dtype}")
    x = torch.randn(N_WORKERS, main_len, generator=gen, device=device)
    p = torch.randn(main_len, generator=gen, device=device)
    got = ops.aggregate_and_apply(x, p, lr=LR)
    want = hier_agg.plain_aggregate_and_apply(x, p, LR)
    err = require_close(got, want, 1e-5, 1e-6,
                        f"aggregate_and_apply ({N_WORKERS}, {main_len}) f32")
    log(f"  aggregate_and_apply: 4 sweep cases + ({N_WORKERS}, {main_len}) "
        f"f32 within rtol 1e-5 / atol 1e-6; main shape bit-equal "
        f"{bool(torch.equal(got, want))}, max abs err {err:.3e}")
    return err


def ssd_inputs(gen, device, b, s, h, p, n, dtype, dt_dtype=None,
               d_dtype=None, slow_decay=False, bc_views=False):
    """tests/test_kernels.py's distribution: x, B, C ~ N(0, 1);
    dt = |N| * 0.5 + 0.01; A = -(|N| + 0.5); D ~ N(0, 1). slow_decay:
    Mamba2's initial ranges instead, dt log-uniform in [1e-3, 1e-1] and
    A = -U[1, 16], so the state lives across chunks. bc_views: B and C
    the two halves of one (b, s, 2n) tensor, as the model splits them."""
    import torch

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=device)
    x = rn(b, s, h, p).to(dtype)
    if slow_decay:
        u = torch.rand(b, s, h, generator=gen, device=device)
        dt = torch.exp(math.log(1e-3) + u * math.log(100.0))
        A = -(1.0 + 15.0 * torch.rand(h, generator=gen, device=device))
    else:
        dt = rn(b, s, h).abs() * 0.5 + 0.01
        A = -(rn(h).abs() + 0.5)
    dt = dt.to(dt_dtype or dtype)
    if bc_views:
        B, C = torch.split(rn(b, s, 2 * n).to(dtype), n, dim=-1)
    else:
        B, C = rn(b, s, n).to(dtype), rn(b, s, n).to(dtype)
    D = rn(h).to(d_dtype or torch.float32)
    return x, dt, A, B, C, D


def ssd_tol(dtype):
    import torch
    if dtype == torch.bfloat16:
        return (5e-2, 5e-2), (1e-2, 1e-2)      # y, state
    return (2e-4, 2e-4), (2e-4, 2e-4)


def check_ssd(device, shape, gen):
    """Returns the max abs error of y of the tensor-core route at the
    scoring shape."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    routes = dict(ssd.ROUTE_LAUNCHES)
    want_routes = {"wgmma": 0, "cuda_cores": 0}
    rels = []                        # relative norm errors, wgmma route

    def held(got, want, dtype, what, route):
        (y, S), (wy, wS) = got, want
        (yr, ya), (sr, sa) = ssd_tol(dtype)
        err = require_close(y, wy, yr, ya, f"ssd y {what}")
        require_close(S, wS, sr, sa, f"ssd state {what}")
        want_routes[route] += 1
        if route == "wgmma":
            rels.append(rel_norm_err(y, wy))
            require(rels[-1] < SSD_BF16_REL_NORM, f"ssd y {what}: relative "
                    f"norm error {rels[-1]:.3e} >= {SSD_BF16_REL_NORM}")
        return err

    def padded_plain(args, s, chunk):
        c = min(chunk, max(16, s))
        pad = (-s) % c
        padded = [torch.nn.functional.pad(
            a, [0, 0] * (a.dim() - 2) + [0, pad]) if a.dim() > 1 else a
            for a in args]
        wy, wS = ssd.plain_ssd_scan(*padded, c)
        return (wy[:, :s], wS), ssd.ssd_route(args[0].dtype, args[0].shape[3],
                                               args[3].shape[2], c)

    cases = 0
    for s, chunk in ((64, 16), (100, 32), (256, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(gen, device, 2, s, 4, 16, 8, dtype)
            want, route = padded_plain(args, s, chunk)
            held(ops.ssd_scan(*args, chunk=chunk), want, dtype,
                 f"s={s} chunk={chunk} {dtype}", route)
            cases += 1
    b, s, h, p, n, chunk = shape
    for s_, chunk_ in ((256, 64), (320, 64), (300, 64), (2048, 256),
                       (300, 256)):            # 300 pads to 320 and to 512
        args = ssd_inputs(gen, device, 2, s_, 4, p, n, torch.bfloat16,
                          dt_dtype=torch.float32, bc_views=True)
        want, route = padded_plain(args, s_, chunk_)
        require(route == "wgmma", f"s={s_} chunk={chunk_} routes to {route}")
        held(ops.ssd_scan(*args, chunk=chunk_), want, torch.bfloat16,
             f"bf16 s={s_} chunk={chunk_} p={p} n={n}", route)
        cases += 1
    for route in ("wgmma", "cuda_cores"):
        args = ssd_inputs(gen, device, 2, 4 * chunk, 4, p, n, torch.bfloat16,
                          dt_dtype=torch.float32, slow_decay=True,
                          bc_views=True)
        want = ssd.plain_ssd_scan(*args, chunk)
        require(float(want[1].abs().max()) > 0.1, "slow-decay state ~0")
        held(ssd.ssd_scan(*args, chunk=chunk, route=route), want,
             torch.bfloat16, f"slow decay s={4 * chunk} on {route}", route)
        cases += 1
    new = {r: k - routes[r] for r, k in ssd.ROUTE_LAUNCHES.items()}
    if device.type == "cuda":              # a CPU rehearsal launches nothing
        require(new == want_routes, f"ssd routes {new} != {want_routes}")
    log(f"  ssd_scan: {cases} cases within tolerance (routes {new}); "
        f"wgmma relative norm errors {', '.join(f'{r:.3e}' for r in rels)} "
        f"(limit {SSD_BF16_REL_NORM})")
    return check_ssd_shape(device, shape, gen, "mamba2-2.7b")


# ---------------------------------------------------------------------------
# phases 8 and 9: the SSM family through the port's entry points
# ---------------------------------------------------------------------------


def check_ssm_wiring(cfg, device, batch_size: int, seq: int):
    """Kernel loss == plain loss; prefill == kernel forward; decode ==
    prefill (last position)."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.models import mamba2, registry
    params = registry.init(0, cfg, device)
    batch = T.from_numpy(make_loader(cfg, seq).next_batch(batch_size), device)
    toks = batch["tokens"]
    on = cfg.replace(use_ssd_kernel=True)
    with torch.no_grad():
        l0 = float(registry.loss_fn(params, cfg, batch))
        l1 = float(registry.loss_fn(params, on, batch))
        kern = mamba2.forward(params, on, toks)[0][:, -1].float()
        full = registry.prefill(params, cfg, {"tokens": toks})[0][:, -1]
        _, cache = registry.prefill(params, cfg, {"tokens": toks[:, :-1]})
        dec = registry.decode_step(params, cfg, cache, seq - 1,
                                   toks[:, -1:])[0][:, 0]
    log(f"  ssm wiring (d_model {cfg.d_model}, {cfg.n_layers} layers, f32, "
        f"{batch_size} x {seq}): loss off {l0!r} on {l1!r}; last-position "
        f"logits prefill vs kernel forward {max_err(full, kern):.3e}, decode "
        f"vs prefill {max_err(dec, full):.3e}")
    require(math.isfinite(l0) and abs(l1 - l0) <= 1e-4 * abs(l0),
            f"ssm wiring loss: kernel {l1!r} vs plain {l0!r} (rtol 1e-4)")
    require_close(full, kern, 1e-4, 1e-4, "prefill vs kernel forward")
    require_close(dec, full, 3e-4, 3e-4, "decode vs prefill")


def check_ssm_wiring_bf16(cfg, device, batch_size: int, seq: int):
    """bf16, where the kernel takes the tensor-core route: the loss and the
    last position's logits with the kernel against the plain ssd_chunked
    path."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import mamba2, registry
    params = registry.init(0, cfg, device)
    batch = T.from_numpy(make_loader(cfg, seq).next_batch(batch_size), device)
    on = cfg.replace(use_ssd_kernel=True)
    routes = dict(ssd.ROUTE_LAUNCHES)
    with torch.no_grad():
        l0 = float(registry.loss_fn(params, cfg, batch))
        l1 = float(registry.loss_fn(params, on, batch))
        plain = mamba2.forward(params, cfg, batch["tokens"])[0][:, -1]
        kern = mamba2.forward(params, on, batch["tokens"])[0][:, -1]
    new = ssd.ROUTE_LAUNCHES["wgmma"] - routes["wgmma"]
    rel = rel_norm_err(kern, plain)
    log(f"  ssm wiring (d_model {cfg.d_model}, {cfg.n_layers} layers, bf16, "
        f"{batch_size} x {seq}): loss off {l0!r} on {l1!r} (rel "
        f"{abs(l1 - l0) / abs(l0):.3e}); last-position logits relative norm "
        f"err {rel:.3e}, max abs err {max_err(kern, plain):.3e}; {new} "
        "tensor-core launches")
    require(device.type == "cpu" or new == 2 * cfg.n_layers,
            f"{new} wgmma launches, want {2 * cfg.n_layers}")
    require(math.isfinite(l0) and abs(l1 - l0) <= SSM_BF16_LOSS_RTOL
            * abs(l0), f"bf16 ssm wiring loss: kernel {l1!r} vs plain {l0!r} "
            f"(rtol {SSM_BF16_LOSS_RTOL})")
    require(rel < SSM_BF16_LOGITS_REL_NORM, f"bf16 ssm wiring logits: "
            f"relative norm error {rel:.3e} >= {SSM_BF16_LOGITS_REL_NORM}")


def kernel_counts():
    from repro_torch.kernels import adamw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hier_agg
    from repro_torch.kernels import ssd_scan as ssd
    return {"aggregate_shards": hier_agg.LAUNCHES,
            "aggregate_and_apply": hier_agg.APPLY_LAUNCHES,
            "flash_attention": fa.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES,
            "ssd_scan": ssd.LAUNCHES,
            "adamw_update": adamw.LAUNCHES,
            "sum_squares": adamw.SUMSQ_LAUNCHES}


def flash_routes():
    """The flash forward's and backward's launches by route."""
    from repro_torch.kernels import flash_attention as fa
    return {"fwd": dict(fa.ROUTE_LAUNCHES), "bwd": dict(fa.BWD_ROUTE_LAUNCHES)}


def require_wgmma(routes: dict, want: dict, what: str):
    """Every flash forward and backward of ``want``'s counts on wgmma."""
    need = {"fwd": {"wgmma": want["flash_attention"], "cuda_cores": 0},
            "bwd": {"wgmma": want["flash_attention_bwd"], "cuda_cores": 0}}
    require(routes == need, f"{what}'s flash routes {routes}: want all on "
            f"wgmma, {need}")


def zero_counts():
    from repro_torch.kernels import adamw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hier_agg
    from repro_torch.kernels import ssd_scan as ssd
    hier_agg.LAUNCHES = hier_agg.APPLY_LAUNCHES = 0
    fa.LAUNCHES = fa.BWD_LAUNCHES = ssd.LAUNCHES = 0
    adamw.LAUNCHES = adamw.SUMSQ_LAUNCHES = 0
    for routes in (fa.ROUTE_LAUNCHES, fa.BWD_ROUTE_LAUNCHES,
                   ssd.ROUTE_LAUNCHES):
        for route in routes:
            routes[route] = 0


def run_scoring(cfg, params, device, batch_size: int, seq: int, evals: int,
                held=None):
    """registry.loss_fn through the model's kernels, the vlm and audio
    batches with modality_inputs; returns (losses, seconds, launches).
    With a list ``held`` the first evaluation runs under
    held_against_plain(held)."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.models import registry
    loader = make_loader(cfg, seq)
    batches = [T.from_numpy(loader.next_batch(batch_size), device)
               for _ in range(evals)]
    for i, batch in enumerate(batches):
        batch.update(modality_inputs(cfg, batch_size, seq, device, seed=i))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    zero_counts()
    losses, secs = [], []
    for i, batch in enumerate(batches):
        hold = held_against_plain(held) if held is not None and i == 0 \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with torch.no_grad(), hold:
            loss = registry.loss_fn(params, cfg, batch)
        sync()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = kernel_counts()
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    return losses, secs, launches


def run_serving(cfg, params, device, n_requests: int, prompt_len: int,
                new_tokens: int, held=None):
    """ServingEngine.serve_batch; returns (completions, stats, launches).
    With a list ``held`` the batch runs under held_against_plain(held)."""
    import numpy as np
    import torch
    from repro_torch.serving import Request, ServingEngine
    rng = np.random.RandomState(0)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, prompt_len)
                    .astype(np.int32), new_tokens) for i in range(n_requests)]
    engine = ServingEngine(cfg, params=params, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    zero_counts()
    with held_against_plain(held) if held is not None \
            else contextlib.nullcontext():
        out = engine.serve_batch(reqs)
    launches = kernel_counts()
    require([c.rid for c in out] == list(range(n_requests)),
            "completions out of order")
    for c in out:
        require(c.tokens.shape == (new_tokens,), f"tokens {c.tokens.shape}")
        require(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
                "a generated token is outside the vocabulary")
    return out, engine.last_stats, launches


# ---------------------------------------------------------------------------
# phase 10: timing of the second slice's kernels
# ---------------------------------------------------------------------------


def time_slice_kernels(device, main_len: int, shape, gen):
    import torch
    from repro_torch.kernels import hier_agg
    out = {}
    out["ssd_scan"], out["ssd_scan_cuda_cores_ms"] = time_ssd(device, shape,
                                                              gen)
    x = torch.randn(N_WORKERS, main_len, generator=gen, device=device)
    p = torch.randn(main_len, generator=gen, device=device)
    nbytes = (N_WORKERS + 2) * main_len * x.element_size()
    out["aggregate_and_apply"] = dict(
        ms=time_ms(lambda: hier_agg.aggregate_and_apply(x, p, LR)),
        call_ms=call_ms(lambda: hier_agg.aggregate_and_apply(x, p, LR)),
        plain_ms=time_ms(lambda: hier_agg.plain_aggregate_and_apply(x, p,
                                                                    LR)),
        library_ms=time_ms(lambda: (p.float() - LR * x.mean(
            0, dtype=torch.float32)).to(p.dtype)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return out


def time_ssd(device, shape, gen):
    """Both SSD routes at ``shape`` (b, s, h, p, n, chunk) with the model's
    dtypes and B / C views, twice each in turns, with the bound; returns
    (the tensor-core route's entry, the CUDA-core route's ms)."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    b, s, h, p, n, chunk = shape
    args = ssd_inputs(gen, device, b, s, h, p, n, torch.bfloat16,
                      dt_dtype=torch.float32, d_dtype=torch.bfloat16,
                      bc_views=True)
    nc, q = s // chunk, chunk
    # the least work: C B^T once per (batch, chunk) on the pairs the causal
    # mask leaves, then for each (batch, head, chunk) scores @ (x dt) on
    # those pairs, C @ S and the state update
    flops = b * nc * n * q * (q + 1) + b * h * nc * (
        p * q * (q + 1) + 4 * q * n * p)
    # each kernel's own count. The tensor-core kernel: n padded to 128 and
    # p to 64, whole 64 x 64 tiles on and below the diagonal, C B^T for
    # each head, and P, S^ and the decayed B^T as two bf16 products each.
    # PR 12's kernel: C B^T for each head and scores @ (x dt) on the causal
    # pairs, C @ S and the state update
    tiles, npad, ppad = q // 64, 128, 64
    own = {"wgmma": b * h * nc * (
        tiles * (tiles + 1) // 2 * (2 * 64 * 64 * npad + 2 * 2 * 64 * 64 * ppad)
        + tiles * 2 * 2 * 64 * npad * ppad + tiles * 2 * 2 * npad * 64 * ppad),
        "cuda_cores": b * h * nc * ((n + p) * q * (q + 1) + 4 * q * n * p)}
    io = sum(a.numel() * a.element_size() for a in args)       # inputs once
    io += args[0].numel() * args[0].element_size() + b * h * n * p * 4
    bound_ms = max(flops / BF16_FLOPS_PER_S, io / HBM_BYTES_PER_S) * 1e3
    log(f"  ssd_scan bound inputs: {flops} FLOPs (least work), {io} bytes; "
        f"the kernels' own counts: {own}")
    routes = {}
    for route in ("wgmma", "cuda_cores", "wgmma", "cuda_cores"):
        t = time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk, route=route))
        routes.setdefault(route, []).append(t)
    for route, ts in routes.items():
        log(f"  ssd_scan {route} at {shape} bf16 on the model's views: "
            f"{' / '.join(f'{t:.4f}' for t in ts)} ms back to back; "
            f"{own[route] / min(ts) / 1e9:.1f} TFLOP/s on its own count, "
            f"{bound_ms / min(ts):.4f} of the bound")
    entry = dict(
        ms=routes["wgmma"][0],
        call_ms=call_ms(lambda: ssd.ssd_scan(*args, chunk=chunk)),
        plain_ms=time_ms(lambda: ssd.plain_ssd_scan(*args, chunk)),
        library_ms=None, bound_ms=bound_ms,
        bound_by="operations" if flops / BF16_FLOPS_PER_S
        >= io / HBM_BYTES_PER_S else "bytes")
    return entry, routes["cuda_cores"][0]

# ---------------------------------------------------------------------------
# phases 11-14: the hybrid and MoE families
# ---------------------------------------------------------------------------


def check_flash_head_dim(device, gen, d: int) -> float:
    """Both flash routes at head dim ``d`` on the model's (b, s, h, d)
    views, causal with windows {0, 64, 4096} at s in {256, 8192} (the
    window bites at 8192); returns the bf16 route's max abs error at the
    last case."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    routes = dict(fa.ROUTE_LAUNCHES)
    rels = []
    cases = {torch.float32: 0, torch.bfloat16: 0}
    for dtype in (torch.float32, torch.bfloat16):
        for seq in (256, 8192):
            for window in (0, 64, 4096):
                q, k, v = bshd_views((1, 4, seq, d), dtype, gen, device)
                got = fa.flash_attention(q, k, v, causal=True, window=window)
                want = fa.plain_flash_attention(q, k, v, causal=True,
                                                window=window)
                what = (f"flash d={d} s={seq} window={window} {dtype} on "
                        "(b, s, h, d) views")
                err = require_close(got, want, *tol(dtype), what)
                if dtype == torch.bfloat16:
                    rels.append(rel_norm_err(got, want))
                    require(rels[-1] < FLASH_BF16_REL_NORM, f"{what}: "
                            f"relative norm error {rels[-1]:.3e} >= "
                            f"{FLASH_BF16_REL_NORM}")
                cases[dtype] += 1
    new = {r: n - routes[r] for r, n in fa.ROUTE_LAUNCHES.items()}
    if device.type == "cuda":              # a CPU rehearsal launches nothing
        require(new == {"wgmma": cases[torch.bfloat16],
                        "cuda_cores": cases[torch.float32]},
                f"flash d={d} routes {new}: want bf16 on wgmma, f32 on the "
                "CUDA cores")
    log(f"  flash d={d}: {sum(cases.values())} cases within tolerance "
        f"(routes {new}); bf16 relative norm errors "
        f"{', '.join(f'{r:.3e}' for r in rels)} (limit "
        f"{FLASH_BF16_REL_NORM}); last bf16 case max abs err {err:.3e}")
    return err


def check_flash_shapes(device, shapes, gen) -> dict:
    """The bf16 flash kernel at each model's own shape and window
    (``shapes``: (arch, (b, h, s, d), window)) on its (b, s, h, d) views,
    against the plain version: 2e-2/2e-2 and FLASH_BF16_REL_NORM, every
    launch on wgmma; returns each arch's max abs error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    errs = {}
    for arch, shape, window in shapes:
        q, k, v = bshd_views(shape, torch.bfloat16, gen, device)
        routes = dict(fa.ROUTE_LAUNCHES)
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        new = {r: n - routes[r] for r, n in fa.ROUTE_LAUNCHES.items()}
        want = fa.plain_flash_attention(q, k, v, causal=True, window=window)
        what = f"flash at {arch}'s {shape} window {window} bf16"
        err = require_close(got, want, 2e-2, 2e-2, what)
        rel = rel_norm_err(got, want)
        require(rel < FLASH_BF16_REL_NORM, f"{what}: relative norm error "
                f"{rel:.3e} >= {FLASH_BF16_REL_NORM}")
        if device.type == "cuda":          # a CPU rehearsal launches nothing
            require(new == {"wgmma": 1, "cuda_cores": 0},
                    f"{what}: routes {new}, want one wgmma launch")
        log(f"  {what} on (b, s, h, d) views: max abs err {err:.3e}, "
            f"relative norm err {rel:.3e} (limit {FLASH_BF16_REL_NORM}); "
            f"routes {new}")
        errs[arch] = err
        del q, k, v, got, want
    return errs


def check_ssd_shape(device, shape, gen, name: str) -> float:
    """Both SSD routes at a model's scoring shape (b, s, h, p, n, chunk)
    with its dtypes and B / C views, at phase 7's tolerances; returns the
    tensor-core route's max abs error on y."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    b, s, h, p, n, chunk = shape
    require(ssd.ssd_route(torch.bfloat16, p, n, chunk) == "wgmma",
            f"{name}'s SSD shape {shape} does not route to wgmma")
    args = ssd_inputs(gen, device, b, s, h, p, n, torch.bfloat16,
                      dt_dtype=torch.float32, d_dtype=torch.bfloat16,
                      bc_views=True)
    wy, wS = ssd.plain_ssd_scan(*args, chunk)
    (yr, ya), (sr, sa) = ssd_tol(torch.bfloat16)
    routes = dict(ssd.ROUTE_LAUNCHES)
    errs = {}
    for route in ("cuda_cores", "wgmma"):
        what = f"ssd {name} shape {shape} on {route}"
        y, S = ssd.ssd_scan(*args, chunk=chunk, route=route)
        errs[route] = require_close(y, wy, yr, ya, f"{what}: y")
        require_close(S, wS, sr, sa, f"{what}: state")
    rel = rel_norm_err(y, wy)
    require(rel < SSD_BF16_REL_NORM, f"ssd {name} on wgmma: relative norm "
            f"error {rel:.3e} >= {SSD_BF16_REL_NORM}")
    new = {r: k - routes[r] for r, k in ssd.ROUTE_LAUNCHES.items()}
    if device.type == "cuda":
        require(new == {"wgmma": 1, "cuda_cores": 1}, f"ssd routes {new}")
    log(f"  ssd_scan at {name}'s scoring shape (b, s, h, p, n, chunk) = "
        f"{shape}, B and C views of one (b, s, 2n) tensor: max abs err y "
        f"wgmma {errs['wgmma']:.3e}, cuda_cores {errs['cuda_cores']:.3e}; "
        f"wgmma relative norm err {rel:.3e} (limit {SSD_BF16_REL_NORM})")
    return errs["wgmma"]


def attention_sites(cfg) -> int:
    """Flash launches in one forward without a cache: every layer of the
    dense and MoE families, every decoder layer of the audio enc-dec, the
    self layers of the vlm, one per shared-block site of the hybrid."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "vlm":
        return cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


def modality_inputs(cfg, batch_size: int, seq: int, device, seed: int = 0):
    """The vlm's image embeddings or the audio model's frame embeddings at
    configs.batch_extras' shapes, N(0, 1) from a numpy seed, in cfg.dtype
    (an empty dict for the other families)."""
    import numpy as np
    import torch
    from repro_torch.configs import batch_extras
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*t.shape).astype(np.float32))
            .to(device=device, dtype=cfg.dtype)
            for k, t in batch_extras(cfg, batch_size, seq).items()}


def want_launches(flash: int = 0, ssd: int = 0, flash_bwd: int = 0,
                  adamw: int = 0) -> dict:
    """The counts of kernel_counts(); ``adamw`` is the AdamW leaf updates
    on the card (steps times leaves), each one call of the update and one
    of the sum of squares."""
    return {"aggregate_shards": 0, "aggregate_and_apply": 0,
            "flash_attention": flash, "flash_attention_bwd": flash_bwd,
            "ssd_scan": ssd, "adamw_update": adamw, "sum_squares": adamw}


def n_leaves(cfg) -> int:
    """The leaves of ``cfg``'s parameter tree: AdamW.update's kernel calls
    of each kind a step, on a whole tree or a rank's parts of it."""
    from repro_torch.core import tree as T
    from repro_torch.models import registry
    return len(T.leaves(registry.init(0, cfg, "meta")))


@contextlib.contextmanager
def held_against_plain(record: list):
    """Within the block every ops.flash_attention and ops.ssd_scan call,
    and every moe.held_products call (the grouped expert products), is
    also run through its plain version on the same inputs (the model's
    own activations and views) and held to it: flash and the expert
    products at tol(dtype), the SSD's y and state at ssd_tol(dtype), and
    in bf16 the relative norm error of the output within
    FLASH_BF16_REL_NORM, SSD_BF16_REL_NORM or EXPERTS_REL_NORM.
    ``record`` gets (kernel, relative norm error) for each call."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import moe
    flash, scan, grouped = ops.flash_attention, ops.ssd_scan, \
        moe.held_products

    def held(name, got, want, rtol, atol, rel_limit):
        what = f"{name} call {len(record)} inside the model"
        require_close(got, want, rtol, atol, what)
        rel = rel_norm_err(got, want)
        record.append((name, rel))
        if got.dtype == torch.bfloat16:
            require(rel < rel_limit, f"{what}: relative norm error "
                    f"{rel:.3e} >= {rel_limit}")

    def flash_held(q, k, v, *, causal, window, **kw):
        out = flash(q, k, v, causal=causal, window=window, **kw)
        want = fa.plain_flash_attention(q, k, v, causal=causal,
                                        window=window, scale=kw.get("scale"))
        held("flash_attention", out, want, *tol(q.dtype),
             FLASH_BF16_REL_NORM)
        return out

    def scan_held(x, dt, A, B, C, D, *, chunk):
        y, S = scan(x, dt, A, B, C, D, chunk=chunk)
        require(x.shape[1] % chunk == 0, "held SSD calls need whole chunks")
        wy, wS = ssd.plain_ssd_scan(x, dt, A, B, C, D, chunk)
        (yr, ya), (sr, sa) = ssd_tol(x.dtype)
        require_close(S, wS, sr, sa, f"ssd_scan call {len(record)} inside "
                      "the model: state")
        held("ssd_scan", y, wy, yr, ya, SSD_BF16_REL_NORM)
        return y, S

    def experts_held(ex, xs, counts, rows):
        got = grouped(ex, xs, counts, rows)
        want = moe.plain_held_products(ex, xs, rows)
        require(got.shape == want.shape, f"expert products call "
                f"{len(record)}: {tuple(got.shape)} != {tuple(want.shape)}")
        held("expert_products", got, want, *tol(xs.dtype), EXPERTS_REL_NORM)
        return got

    ops.flash_attention, ops.ssd_scan = flash_held, scan_held
    moe.held_products = experts_held
    try:
        yield record
    finally:
        ops.flash_attention, ops.ssd_scan = flash, scan
        moe.held_products = grouped


def check_family_wiring(cfg, device, batch_size: int, seq: int, kernels,
                        loss_rtol: float, flash_logits: bool = False):
    """The loss with the model's kernels (``kernels``: names of its
    ``use_<name>_kernel`` flags) on against off, with every kernel call of
    the kernel loss held against its plain version on the model's own
    inputs (held_against_plain). With ``flash_logits`` also the last
    position's logits with the flash kernel alone on against the plain
    path, within HYBRID_FLASH_LOGITS_REL_NORM. Each kernel's launches in
    the kernel loss are counted, on the route the dtype takes. The vlm
    and audio batches carry modality_inputs, and the vlm's gates are
    opened to XATTN_GATE. Returns (params, batch)."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import registry
    params = registry.init(0, cfg, device)
    if cfg.family == "vlm":
        for g in ("gate_attn", "gate_mlp"):
            params["cross"][g].fill_(XATTN_GATE)
    batch = T.from_numpy(make_loader(cfg, seq).next_batch(batch_size), device)
    batch.update(modality_inputs(cfg, batch_size, seq, device))
    on = cfg.replace(**{f"use_{k}_kernel": True for k in kernels})
    calls = []
    with torch.no_grad():
        l0 = float(registry.loss_fn(params, cfg, batch))
        zero_counts()
        with held_against_plain(calls):
            l1 = float(registry.loss_fn(params, on, batch))
        launches = kernel_counts()
        routes = {"flash": dict(fa.ROUTE_LAUNCHES),
                  "ssd": dict(ssd.ROUTE_LAUNCHES)}
        rel = None
        if flash_logits:
            fwd = registry.family_module(cfg).forward_full
            toks = batch["tokens"]
            flash_on = cfg.replace(use_flash_kernel=True)
            rel = rel_norm_err(fwd(params, flash_on, toks)[0][:, -1],
                               fwd(params, cfg, toks)[0][:, -1])
    bf16 = cfg.dtype == torch.bfloat16
    worst = {}
    for name, r in calls:
        worst[name] = max(worst.get(name, 0.0), r)
    log(f"  {cfg.arch_id} wiring ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {'bf16' if bf16 else 'f32'}, {batch_size} x {seq}): "
        f"loss off {l0!r} on {l1!r} (rel {abs(l1 - l0) / abs(l0):.3e}, "
        f"limit {loss_rtol}); {len(calls)} kernel calls held against their "
        f"plain versions on the model's inputs, largest relative norm err "
        f"{', '.join(f'{k} {v:.3e}' for k, v in worst.items())}"
        + (f"; last-position logits, flash kernel alone against plain: "
           f"relative norm err {rel:.3e} (limit "
           f"{HYBRID_FLASH_LOGITS_REL_NORM})" if flash_logits else "")
        + f"; launches {launches}, routes {routes}")
    want = want_launches(
        flash=attention_sites(cfg) if "flash" in kernels else 0,
        ssd=cfg.n_layers if "ssd" in kernels else 0)
    require(len(calls) == want["flash_attention"] + want["ssd_scan"],
            f"{len(calls)} kernel calls held, want {want}")
    route = "wgmma" if bf16 else "cuda_cores"
    if device.type == "cuda":
        require(launches == want, f"wiring launches {launches} != {want}")
        for name, key in (("flash", "flash_attention"), ("ssd", "ssd_scan")):
            require(routes[name][route] == want[key], f"{name} launches "
                    f"{routes[name]}: want all {want[key]} on {route}")
    require(math.isfinite(l0) and abs(l1 - l0) <= loss_rtol * abs(l0),
            f"{cfg.arch_id} wiring loss: kernels {l1!r} vs plain {l0!r} "
            f"(rtol {loss_rtol})")
    if flash_logits:
        require(rel < HYBRID_FLASH_LOGITS_REL_NORM, f"{cfg.arch_id} wiring "
                f"logits: the flash path is {rel:.3e} from the plain path, "
                f"limit {HYBRID_FLASH_LOGITS_REL_NORM}")
    return params, batch


def check_cross_decode(cfg, params, batch):
    """Phase 20's cache paths of a vlm or audio model (f32): prefill's
    last-position logits against the loss forward's (the flash kernel on,
    no cache; rtol 1e-4 / atol 1e-4, as phase 8), and teacher-forced
    decode after a half prefill against prefill, 3 steps (rtol 2e-2 /
    atol 2e-3, tests/test_arch_smoke.py:57-74). Neither prefill nor decode
    launches the flash kernel: both attend through the KV cache."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import encdec, registry, vlm
    on = cfg.replace(use_flash_kernel=True)
    toks = batch["tokens"]
    seq = toks.shape[1]
    half = seq // 2
    with torch.no_grad():
        if cfg.family == "vlm":
            ikv = vlm.image_kv_from_embeds(params, on, batch["image_embeds"])
            fwd = vlm.forward(params, on, toks, ikv)[0][:, -1]
        else:
            enc = encdec.encode(params, on, batch["audio_frames"])
            fwd = encdec.decode_stack(params, on, toks,
                                      encdec.cross_kv(params, on, enc))[0]
            fwd = fwd[:, -1]
        zero_counts()
        full = registry.prefill(params, on, batch, max_seq=seq)[0]
        last, want = full[:, -1].clone(), full[:, half:half + 3].clone()
        del full
        _, cache = registry.prefill(params, on,
                                    dict(batch, tokens=toks[:, :half]),
                                    max_seq=seq)
        steps = []
        for i, t in enumerate(range(half, half + 3)):
            logits, cache = registry.decode_step(params, on, cache, t,
                                                 toks[:, t:t + 1])
            steps.append((logits[:, 0], want[:, i]))
        launches = fa.LAUNCHES
    log(f"  {cfg.arch_id} cache paths: prefill vs loss forward, last "
        f"position, max abs err {max_err(last, fwd):.3e} (rtol 1e-4 / atol "
        f"1e-4); decode after a prefill of {half} vs prefill at positions "
        f"{half}..{half + 2}: max abs err "
        f"{', '.join(f'{max_err(g, w):.3e}' for g, w in steps)} (rtol 2e-2 "
        f"/ atol 2e-3); flash launches {launches}")
    require_close(last, fwd, 1e-4, 1e-4, f"{cfg.arch_id} prefill vs loss "
                  "forward")
    for i, (g, w) in enumerate(steps):
        require_close(g, w, 2e-2, 2e-3, f"{cfg.arch_id} decode at "
                      f"{half + i} vs prefill")
    require(launches == 0, f"{launches} flash launches in prefill and "
            "decode, want 0")


def run_family(cfg, device, n_params: int, batch_size: int, seq: int,
               hold_first: bool = False, hold_serve: bool = False):
    """One full-width model through the port's entry points: SCORE_EVALS
    scoring evaluations on batch_size x seq tokens, then ServingEngine on
    SERVE_REQUESTS prompts of seq tokens. Checks the parameter count,
    every launch count and the peaks (under 80 GB); with ``hold_first``
    every kernel call of the first evaluation is held against its plain
    version (held_against_plain), and with ``hold_serve`` every kernel
    call of the serving prefill, in a second, untimed serving of the same
    requests. Returns a summary."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import hybrid, registry
    n = registry.param_count(cfg)
    require(n == n_params, f"{cfg.arch_id} has {n} params, want {n_params}")
    flags = [k for k in ("flash", "ssd") if getattr(cfg, f"use_{k}_kernel")]
    params = registry.init(0, cfg, device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = [] if hold_first else None
    losses, secs, score_l = run_scoring(cfg, params, device, batch_size, seq,
                                        SCORE_EVALS, held=held)
    score_peak = torch.cuda.max_memory_allocated()
    tokens = batch_size * seq
    log(f"  scoring: {SCORE_EVALS} evaluations of loss_fn on {batch_size} x "
        f"{seq} tokens: losses {losses}")
    log(f"  scoring seconds {secs}; tokens/s {[tokens / t for t in secs]}; "
        f"peak memory {score_peak} bytes ({score_peak / 2**30:.2f} GiB)"
        + ("; the first evaluation also ran each kernel's plain version"
           if hold_first else ""))
    want = want_launches(
        flash=attention_sites(cfg) * SCORE_EVALS if "flash" in flags else 0,
        ssd=cfg.n_layers * SCORE_EVALS if "ssd" in flags else 0)
    if hold_first:
        per_eval = (want["flash_attention"] + want["ssd_scan"]) // SCORE_EVALS
        log(f"  the first evaluation's {len(held)} kernel calls held against "
            f"their plain versions: largest relative norm err "
            f"{max(r for _, r in held):.3e}")
        require(len(held) == per_eval,
                f"{len(held)} kernel calls held, want {per_eval}")
    routes = {"flash": dict(fa.ROUTE_LAUNCHES),
              "ssd": dict(ssd.ROUTE_LAUNCHES)}
    log(f"  scoring launches {score_l}, expected {want}; routes {routes}")
    require(score_l == want, f"scoring launch counts {score_l} != {want}")
    require(routes == {"flash": {"wgmma": want["flash_attention"],
                                 "cuda_cores": 0},
                       "ssd": {"wgmma": want["ssd_scan"], "cuda_cores": 0}},
            f"bf16 scoring's routes {routes}: want all on wgmma")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the hybrid's prefill runs its shared block's attention without a
    # cache (the ring is filled from k and v apart), so through the flash
    # kernel; the MoE prefill attends through its KV cache. A prefill
    # starts from the zero state, so each Mamba2 layer runs the SSD kernel
    prefill_flash = attention_sites(cfg) if cfg.family == "hybrid" \
        and "flash" in flags else 0
    prefill_ssd = cfg.n_layers if "ssd" in flags else 0
    out, stats, serve_l = run_serving(cfg, params, device, SERVE_REQUESTS,
                                      seq, SERVE_NEW_TOKENS)
    serve_peak = torch.cuda.max_memory_allocated()
    per_tok_ms = stats["decode_s"] / (SERVE_NEW_TOKENS - 1) \
        / SERVE_REQUESTS * 1e3
    log(f"  serving: {SERVE_REQUESTS} requests x {seq}-token prompts, "
        f"{SERVE_NEW_TOKENS} new tokens each; prefill {stats['prefill_s']!r} "
        f"s ({SERVE_REQUESTS * seq / stats['prefill_s']!r} tokens/s), decode "
        f"{stats['decode_s']!r} s ({per_tok_ms!r} ms per token per request); "
        f"peak memory {serve_peak} bytes ({serve_peak / 2**30:.2f} GiB)")
    want_serve = want_launches(flash=prefill_flash, ssd=prefill_ssd)
    log(f"  serving launches {serve_l}, expected {want_serve}; first "
        f"request's tokens {out[0].tokens.tolist()}")
    require(serve_l == want_serve,
            f"serving launch counts {serve_l} != {want_serve}")
    require(max(score_peak, serve_peak) < 80e9, "a peak of 80 GB or more")
    if hold_serve:
        held = []
        again, _, _ = run_serving(cfg, params, device, SERVE_REQUESTS, seq,
                                  SERVE_NEW_TOKENS, held=held)
        n_held = {}
        for name, _ in held:
            n_held[name] = n_held.get(name, 0) + 1
        want_held = {k: v for k, v in (("flash_attention", prefill_flash),
                                       ("ssd_scan", prefill_ssd)) if v}
        same = all(a.tokens.tolist() == b.tokens.tolist()
                   for a, b in zip(again, out))
        log(f"  the serving prefill held against the plain versions: calls "
            f"{n_held}, largest relative norm err "
            f"{max(r for _, r in held):.3e}; tokens equal the timed "
            f"serving's: {same}")
        require(n_held == want_held, f"serving prefill calls held {n_held}, "
                f"want {want_held}")
        del again
    if cfg.family == "hybrid":
        ring = hybrid.ring_size(cfg, seq + SERVE_NEW_TOKENS)
        require(ring == cfg.sliding_window and seq % ring == 0,
                f"ring of {ring} slots: the first decode step at position "
                f"{seq} does not write slot 0")
        log(f"  ring cache: {ring} slots a site; decode positions {seq}.."
            f"{seq + SERVE_NEW_TOKENS - 2} write slots 0..{SERVE_NEW_TOKENS - 2}"
            ": the ring wrapped")
    del params, out
    torch.cuda.empty_cache()
    return dict(score_launches=score_l, serve_launches=serve_l,
                score_s=secs, score_peak=score_peak,
                prefill_s=stats["prefill_s"], decode_ms=per_tok_ms,
                serve_peak=serve_peak)


# ---------------------------------------------------------------------------
# phase 40: granite-4.0-h-small, the benchmark's hybrid MoE cell
# ---------------------------------------------------------------------------


def granite_config():
    """The ModelConfig of the benchmark's granite-4.0-h-small file."""
    import torch
    from repro_torch.models.base import ModelConfig
    c = json.loads(GRANITE_CONFIG.read_text())
    kw = dict(c["model"], dtype=getattr(torch, c["model"]["dtype"]))
    return ModelConfig(arch_id=c["name"], source=c["source"], **kw)


@contextlib.contextmanager
def kernel_calls(record: list):
    """Within the block each ops.flash_attention call appends ("flash",
    q's shape, k's shape, its scale) to ``record`` and each ops.ssd_scan
    call ("ssd", x's shape, B's shape, the chunk). Entered outside
    held_against_plain, it sees each call once."""
    from repro_torch.kernels import ops
    flash, scan = ops.flash_attention, ops.ssd_scan

    def flash_seen(q, k, v, **kw):
        record.append(("flash", tuple(q.shape), tuple(k.shape),
                       kw.get("scale")))
        return flash(q, k, v, **kw)

    def scan_seen(x, dt, A, B, C, D, *, chunk):
        record.append(("ssd", tuple(x.shape), tuple(B.shape), chunk))
        return scan(x, dt, A, B, C, D, chunk=chunk)

    ops.flash_attention, ops.ssd_scan = flash_seen, scan_seen
    try:
        yield record
    finally:
        ops.flash_attention, ops.ssd_scan = flash, scan


def run_granite(device) -> dict:
    """Phase 40 (see the module's docstring); returns a summary."""
    import torch
    from repro_torch.core import spans
    from repro_torch.core import tree as T
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import registry
    cfg = granite_config()
    n = registry.param_count(cfg)
    require(n == GRANITE_PARAMS, f"{cfg.arch_id} holds {n} params, want "
            f"{GRANITE_PARAMS}")
    kinds = list(cfg.layer_types)
    n_attn, n_mamba = kinds.count("attention"), kinds.count("mamba")
    params = registry.init(0, cfg, device)
    loader = make_loader(cfg, GRANITE_SEQ)
    batches = [T.from_numpy(loader.next_batch(GRANITE_BATCH), device)
               for _ in range(1 + SCORE_EVALS)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    seen, held = [], []
    zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), kernel_calls(seen), held_against_plain(held):
        held_loss = float(registry.loss_fn(params, cfg, batches[0]))
    torch.cuda.synchronize()
    held_s = time.perf_counter() - t0
    launches = kernel_counts()
    routes = {"flash": flash_routes()["fwd"], "ssd": dict(ssd.ROUTE_LAUNCHES)}
    worst = {}
    for name, r in held:
        worst[name] = max(worst.get(name, 0.0), r)
    log(f"  the held evaluation ({held_s:.1f} s): loss {held_loss!r}; "
        f"{len(held)} kernel calls held against their plain versions, "
        f"largest relative norm err "
        f"{', '.join(f'{k} {v:.3e}' for k, v in worst.items())}")
    log(f"  calls seen: {sorted(set(seen))}; launches {launches}, routes "
        f"{routes}")
    want = want_launches(flash=n_attn, ssd=n_mamba)
    require(launches == want, f"the held evaluation's launches {launches} "
            f"!= {want}")
    require(routes == {"flash": {"wgmma": n_attn, "cuda_cores": 0},
                       "ssd": {"wgmma": n_mamba, "cuda_cores": 0}},
            f"the held evaluation's routes {routes}: want all on wgmma")
    n_held = {}
    for name, _ in held:
        n_held[name] = n_held.get(name, 0) + 1
    want_held = {"flash_attention": n_attn, "ssd_scan": n_mamba,
                 "expert_products": cfg.n_layers}
    require(n_held == want_held, f"calls held {n_held}, want {want_held}")
    b, s, d = GRANITE_BATCH, GRANITE_SEQ, cfg.resolved_head_dim
    h = cfg.d_model * cfg.ssm_expand // cfg.ssm_headdim
    want_seen = (
        [("flash", (b, cfg.n_heads, s, d), (b, cfg.n_heads, s, d),
          cfg.attention_multiplier)] * n_attn
        + [("ssd", (b, s, h, cfg.ssm_headdim), (b, s, cfg.ssm_state),
            cfg.ssm_chunk)] * n_mamba)
    require(sorted(seen) == sorted(want_seen), f"calls seen {seen}, want "
            f"{sorted(set(want_seen))} ({n_attn} and {n_mamba})")

    zero_counts()
    secs, losses = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        with torch.no_grad():
            loss = registry.loss_fn(params, cfg, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = GRANITE_BATCH * GRANITE_SEQ
    log(f"  {SCORE_EVALS} evaluations: losses {losses}; seconds {secs}; "
        f"tokens/s {[tokens / t for t in secs]}; peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    want = want_launches(flash=n_attn * SCORE_EVALS, ssd=n_mamba * SCORE_EVALS)
    require(launches == want, f"scoring launches {launches} != {want}")
    require(all(math.isfinite(x) for x in losses + [held_loss]),
            f"losses {held_loss} {losses}")
    require(peak < 80e9, f"a peak of {peak} bytes")

    spans.clear()
    with torch.no_grad(), spans.recording():
        registry.loss_fn(params, cfg, batches[0])
    counts = {}
    for c in spans.counted():
        counts.setdefault(c.name, []).append(c.value)
    spans.clear()
    pairs = counts.get("moe.pairs_held", [])
    dropped = counts.get("moe.pairs_dropped", [])
    busiest = counts.get("moe.pairs_busiest", [])
    held_experts = cfg.experts_held or cfg.n_experts
    log(f"  counters, one evaluation: held pairs {sum(pairs)} "
        f"({sum(pairs) / (tokens * cfg.top_k * cfg.n_layers):.4f} of the "
        f"routed pairs), dropped {sum(dropped)}, busiest over mean held "
        f"expert {sum(busiest) * held_experts / max(sum(pairs), 1):.3f}")
    require(len(pairs) == len(dropped) == len(busiest) == cfg.n_layers,
            f"counter records {({k: len(v) for k, v in counts.items()})}, "
            f"want {cfg.n_layers} each")
    require(all(0 < x <= tokens * cfg.top_k for x in pairs),
            f"held pairs a layer {pairs}")
    require(not any(dropped), f"dropped pairs a layer {dropped}")
    del params, batches
    torch.cuda.empty_cache()
    return dict(params=n, held_loss=held_loss, losses=losses, score_s=secs,
                peak=peak, held_pairs=sum(pairs), launches=launches)


# ---------------------------------------------------------------------------
# phases 16-18: the hier train step, launch/train.py, the train_e2e example
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 41: the serving engine's captured decode step


def run_decode_graph(device) -> dict:
    """Phase 41 (see the module's docstring); returns a summary."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.core import spans
    from repro_torch.models import registry
    from repro_torch.serving import Request, ServingEngine
    cfg = ARCHS["mamba2-2.7b"].replace(use_ssd_kernel=True)
    require(registry.decode_replayable(cfg, device),
            f"{cfg.arch_id}'s decode is not replayable on {device}")
    params = registry.init(0, cfg, device)
    graphed = ServingEngine(cfg, params=params, device=device)
    eager = ServingEngine(cfg, params=params, device=device)
    replayable = registry.decode_replayable

    def serve(engine, reqs):
        registry.decode_replayable = (replayable if engine is graphed
                                      else lambda cfg, device: False)
        try:
            out = engine.serve_batch(reqs)
        finally:
            registry.decode_replayable = replayable
        st = engine.last_stats
        return out, 1e3 * st["decode_s"] / (st["new_tokens"] - 1)

    b, n = DECODE_GRAPH_BATCH, DECODE_GRAPH_TOKENS
    rng = np.random.RandomState(0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for engine in (graphed, eager):     # every prefill shape; the capture
        for plen in DECODE_GRAPH_LENS:
            serve(engine, [Request(r, np.zeros(plen, np.int32), 2)
                           for r in range(b)])
    capture_s = time.perf_counter() - t0
    require(list(graphed.graphs) == [b] and eager.graphs == {},
            f"graphs {list(graphed.graphs)} / {list(eager.graphs)}")
    rows = []
    spans.clear()
    for plen in DECODE_GRAPH_LENS:
        reqs = [Request(r, rng.randint(0, cfg.vocab_size, plen)
                        .astype(np.int32), n) for r in range(b)]
        want, eager_ms = serve(eager, reqs)
        with spans.recording():
            got, graph_ms = serve(graphed, reqs)
        counts = {c.name: c.value for c in spans.counted()}
        spans.clear()
        same = all(g.tokens.tolist() == w.tokens.tolist()
                   for g, w in zip(got, want))
        rows.append(dict(prompt_len=plen, graph_ms=graph_ms,
                         eager_ms=eager_ms, tokens_equal=same,
                         replayed=counts.get("serve.decode_replayed"),
                         eager=counts.get("serve.decode_eager")))
        log(f"  prompt {plen}: {rows[-1]}")
        require(same, f"graphed tokens differ from eager at prompt {plen}")
        require((rows[-1]["replayed"], rows[-1]["eager"]) == (n - 1, 0),
                f"counters {counts} at prompt {plen}")
    peak = torch.cuda.max_memory_allocated()
    med = {k: statistics.median(r[k] for r in rows)
           for k in ("graph_ms", "eager_ms")}
    log(f"  warm-up and capture {capture_s:.1f} s; peak "
        f"{peak / 2**30:.2f} GiB; a decode step {med['graph_ms']:.2f} ms "
        f"graphed, {med['eager_ms']:.2f} eager (medians over the lengths)")
    return dict(rows=rows, peak_bytes=peak, capture_s=capture_s)


def check_train_step_wiring(cfg, device, batch_size: int, seq: int):
    """Phase 16, ``cfg`` at full width, reduced depth, f32: one
    ``make_train_step("hier")`` step at world size 1 against
    ``registry.loss_fn`` and ``AdamW.update`` called directly (loss rtol
    1e-5, updated params rtol 5e-4 / atol 1e-5), with the flash kernel on
    and off; flash on against off, and remat "full" and "dots" against
    remat off (flash on), on the loss (rtol 1e-5) and the gradient (rtol
    5e-4 / atol 1e-5); the flash launches of each gradient (remat runs the
    forward again)."""
    from repro_torch.core import tree as T
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import process_group
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_local_mesh
    from repro_torch.models import registry
    from repro_torch.optim import AdamW
    params = registry.init(0, cfg, device)
    batch = T.from_numpy(make_loader(cfg, seq).next_batch(batch_size), device)
    opt = AdamW(lr=3e-4)
    grads = {}
    with process_group(device):
        mesh = make_local_mesh(device)
        for flash in (False, True):
            c = cfg.replace(use_flash_kernel=flash)
            zero_counts()
            loss, g = T.value_and_grad(
                lambda p, b: registry.loss_fn(p, c, b))(params, batch)
            want, _ = opt.update(g, opt.init(params), params)
            step = make_train_step(c, mesh, strategy="hier", optimizer=opt)
            got, state, step_loss = step(params, step.init_opt_state(params),
                                         batch)
            require(fa.LAUNCHES == fa.BWD_LAUNCHES == 2 * c.n_layers * flash,
                    f"flash {flash}: {fa.LAUNCHES} launches, "
                    f"{fa.BWD_LAUNCHES} of the backward")
            require(abs(float(step_loss) - float(loss))
                    <= 1e-5 * abs(float(loss)),
                    f"hier step loss {float(step_loss)!r} vs direct "
                    f"{float(loss)!r} (rtol 1e-5)")
            worst = max(require_close(a, b, 5e-4, 1e-5, "hier step params")
                        for a, b in zip(T.leaves(got), T.leaves(want)))
            n_split = sum(s is not None for s in step.shards)
            log(f"  hier step (flash {'on' if flash else 'off'}): loss "
                f"{float(step_loss)!r}, direct {float(loss)!r}; params max "
                f"abs err {worst:.3e}; {n_split} of {len(step.shards)} leaves "
                f"reduce-scattered, AdamW state step {state.step}")
            grads[flash] = (float(loss), g)
            del want, got, state, step
    for name, c in (("flash on", None),
                    ("remat full", cfg.replace(use_flash_kernel=True,
                                               remat=True)),
                    ("remat dots", cfg.replace(use_flash_kernel=True,
                                               remat=True,
                                               remat_policy="dots"))):
        if c is None:
            loss, g = grads[True]
            ref_loss, ref_g = grads[False]
        else:
            zero_counts()
            loss, g = T.value_and_grad(
                lambda p, b: registry.loss_fn(p, c, b))(params, batch)
            loss = float(loss)
            require(fa.LAUNCHES == 2 * c.n_layers
                    and fa.BWD_LAUNCHES == c.n_layers,
                    f"{name}: {fa.LAUNCHES} flash launches and "
                    f"{fa.BWD_LAUNCHES} of the backward, want "
                    f"{2 * c.n_layers} (the forward and its recompute) and "
                    f"{c.n_layers}")
            ref_loss, ref_g = grads[True]
        require(abs(loss - ref_loss) <= 1e-5 * abs(ref_loss),
                f"{name}: loss {loss!r} vs {ref_loss!r} (rtol 1e-5)")
        worst = max(require_close(a, b, 5e-4, 1e-5, f"{name} grads")
                    for a, b in zip(T.leaves(g), T.leaves(ref_g)))
        log(f"  {name} against {'flash off' if c is None else 'remat off'}: "
            f"loss {loss!r} vs {ref_loss!r}; grads max abs err {worst:.3e}")
        del g


def run_hier_training(cfg, device, batch_size: int, seq: int, steps: int,
                      fsdp: bool = False):
    """Phases 17 and 29: ``launch/train.py::train`` with the ``hier`` step
    (ZeRO-3 parameters under ``fsdp``), seed-0 weights; returns (losses,
    step seconds, launches, routes, peak bytes)."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.launch.train import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    params, losses, step_s = train(cfg, steps=steps, batch=batch_size,
                                   seq=seq, strategy="hier", log_every=1,
                                   device=device, fsdp=fsdp)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches, routes = kernel_counts(), flash_routes()
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for p in T.leaves(params):
        require(bool(p.float().isfinite().all()), "non-finite parameters")
    del params
    torch.cuda.empty_cache()
    return losses, step_s, launches, routes, peak


def run_train_e2e(device):
    """Phase 18: the port's train_e2e example at its default size."""
    from repro_torch.examples import train_e2e
    t0 = time.perf_counter()
    losses = train_e2e.main(["--device", str(device)])
    return losses, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phases 30-31: the dry run against the card, the prefill and serve steps
# ---------------------------------------------------------------------------


def check_dryrun(device, batch_size: int, seq: int):
    """Phase 30: the dry run of full-width olmo-1b's ZeRO-3 ``hier`` step
    (remat, the flash kernel) on a one-rank mesh, on fake CUDA tensors,
    against the same step run for real. Returns (prediction, measured
    FLOPs, measured peak, memory held before the step, launches, routes,
    and the step's first moments and update against the same step with
    remat off)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_custom_mesh, process_group
    from repro_torch.models import registry
    from repro_torch.models.base import InputShape
    shape = InputShape(f"train_{batch_size}x{seq}", seq, batch_size,
                       "train")
    pred = D.lower_one("olmo-1b", shape, multi_pod=False, mesh_shape="1x1",
                       device=device.type)
    cfg = D.dryrun_config("olmo-1b", shape)
    with process_group(device):
        mesh = make_custom_mesh("1x1", device.type)
        step = D.make_step(cfg, shape, mesh)
        args = D.step_args(step, cfg, shape, device=device,
                           init=lambda p: registry.init(0, cfg, device))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with FlopCounterMode(display=False) as flops:
            out = step(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches, routes = kernel_counts(), flash_routes()
        require(math.isfinite(float(out[2])), f"loss {float(out[2])}")
        params = args[0]
        del out, args, step
        torch.cuda.empty_cache()
        cmp = compare_remat(cfg, shape, mesh, params, device)
        del params
    torch.cuda.empty_cache()
    return pred, flops.get_total_flops(), peak, held, launches, routes, cmp


def compare_remat(cfg, shape, mesh, params, device) -> dict:
    """Phase 30: one step of ``cfg`` (remat) and one with remat off, from
    the same ``params`` and fresh moments, on the seeded loader's first
    batch (on the dry run's zero batch every position holds the same
    token, so the attention's query and key gradients are zero but for
    rounding, and would compare noise with noise). Returns the worst
    leaf's first-moment relative norm and its path, the update's relative
    norm, and how many bf16 parameters differ."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.launch import dryrun as D
    batch = T.from_numpy(make_loader(cfg, shape.seq_len).next_batch(
        shape.global_batch), device)
    outs = []
    for c in (cfg, cfg.replace(remat=False)):
        step = D.make_step(c, shape, mesh)
        new, state, _ = step(params, step.init_opt_state(params),
                             step.local_batch(batch))
        outs.append(list(zip(T.leaves(new), T.leaves(state.mu))))
        if c.remat:         # to the host while the plain step runs
            outs[0] = [(p.cpu(), m.cpu()) for p, m in outs[0]]
        del new, state, step
        torch.cuda.empty_cache()
    worst, worst_path = 0.0, None
    diff_sq = upd_sq = 0.0
    differ = 0
    for (path, old), (rp, rm), (p, m) in zip(
            T.leaves_with_path(params), *outs, strict=True):
        rp, rm = rp.to(device).float(), rm.to(device)
        d, n = float((rm - m).norm()), float(m.norm())
        err = d / n if n else (0.0 if d == 0 else math.inf)
        if err >= worst:
            worst, worst_path = err, path
        diff_sq += float((rp - p.float()).square().sum())
        upd_sq += float((p.float() - old.float()).square().sum())
        differ += int((rp != p.float()).sum())
    return dict(mu_rel_norm=worst, mu_worst_leaf=worst_path,
                update_rel_norm=math.sqrt(diff_sq / upd_sq),
                params_differing=differ,
                params=sum(x.numel() for x in T.leaves(params)))


def check_prefill_dryrun(device, batch_size: int, seq: int):
    """Phase 30: the dry run of full-width mamba2-2.7b's prefill step with
    the SSD kernel on, one-rank mesh, fake CUDA tensors, against the same
    step run for real under FlopCounterMode; then that step again with
    every kernel call held against its plain version (held_against_plain),
    its logits equal to the counted run's. Returns (prediction, measured
    FLOPs, smlt::ssd_scan's share of them and its calls, the FLOPs
    ssd_flops gives a call, launches, SSD routes, the held calls)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_custom_mesh, process_group
    from repro_torch.models import registry
    from repro_torch.models.base import InputShape
    shape = InputShape(f"prefill_{batch_size}x{seq}", seq, batch_size,
                       "prefill")
    on = {"use_ssd_kernel": True}
    pred = D.lower_one("mamba2-2.7b", shape, multi_pod=False,
                       mesh_shape="1x1", overrides=on, device=device.type)
    cfg = D.dryrun_config("mamba2-2.7b", shape, overrides=on)
    with process_group(device):
        mesh = make_custom_mesh("1x1", device.type)
        step = D.make_step(cfg, shape, mesh)
        args = D.step_args(step, cfg, shape, device=device,
                           init=lambda p: registry.init(0, cfg, device))
        torch.cuda.synchronize()
        zero_counts()
        with FlopCounterMode(display=False) as flops:
            out = step(*args)
        torch.cuda.synchronize()
        launches, routes = kernel_counts(), dict(ssd.ROUTE_LAUNCHES)
        require(bool(out[0].isfinite().all()), "prefill logits not finite")
        held = []
        with held_against_plain(held):
            again = step(*args)
        torch.cuda.synchronize()
        require(torch.equal(again[0], out[0]), "the held prefill's logits "
                "differ from the counted one's")
        del out, again, args, step
    torch.cuda.empty_cache()
    ssd_op = flops.get_flop_counts()["Global"].get(
        torch.ops.smlt.ssd_scan, 0)
    per_call = ssd.ssd_flops(
        (batch_size, seq, cfg.ssm_nheads, cfg.ssm_headdim), None, None,
        (batch_size, seq, cfg.ssm_state), None, None,
        min(cfg.ssm_chunk, seq))
    return (pred, flops.get_total_flops(), ssd_op, per_call, launches,
            routes, held)


def time_prefill_paths(device, batch_size: int, seq: int) -> dict:
    """Phase 30: full-width mamba2-2.7b's ``registry.prefill`` at
    batch_size x seq, seed-0 weights and tokens, through the SSD kernel
    and through ``ssd_chunked``: seconds of each of PREFILL_TIMED calls
    after one warm-up (host clock around a synchronised call), and each
    path's peak memory."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import registry
    cfg = ARCHS["mamba2-2.7b"]
    params = registry.init(0, cfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (batch_size, seq), generator=gen,
                         device=device, dtype=torch.int32)
    out = {}
    for name, kernel in (("kernel", True), ("chunked", False)):
        c = cfg.replace(use_ssd_kernel=kernel)
        secs = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            for i in range(PREFILL_TIMED + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                registry.prefill(params, c, {"tokens": toks})
                torch.cuda.synchronize()
                if i:
                    secs.append(time.perf_counter() - t0)
        out[name] = dict(seconds=secs, peak=torch.cuda.max_memory_allocated(),
                         ms_per_ktok=1e6 * statistics.median(secs)
                         / (batch_size * seq))
    del params
    torch.cuda.empty_cache()
    return out


def run_production_traces(device):
    """Phase 30's traces on the 256-rank production mesh (fake process
    group, fake tensors on ``device``); returns each one's result."""
    from repro_torch.launch.dryrun import lower_one
    out = {}
    for arch, shape in PRODUCTION_TRACES:
        res = lower_one(arch, shape, multi_pod=False, device=device.type)
        for key in ("flops", "bytes_accessed", "collective_bytes"):
            require(math.isfinite(res[key]) and res[key] > 0,
                    f"{arch} {shape}: {key} {res[key]}")
        require(res["memory"]["peak_memory_in_bytes"] > 0,
                f"{arch} {shape}: memory {res['memory']}")
        out[(arch, shape)] = res
    return out


def run_prefill_serve_steps(cfg, device, n_requests: int, prompt_len: int,
                            new_tokens: int):
    """Phase 31: ServingEngine on seed-0 weights (run_serving's prompts),
    then the same prompts through make_prefill_step and make_serve_step
    (fsdp=True) over a one-rank mesh, greedy; returns (engine stats, the
    steps' prefill seconds, decode seconds, launches)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_custom_mesh, process_group
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import registry
    params = registry.init(0, cfg, device)
    out, stats, _ = run_serving(cfg, params, device, n_requests, prompt_len,
                                new_tokens)
    want = np.stack([c.tokens for c in out])
    rng = np.random.RandomState(0)             # run_serving's prompts
    toks = np.stack([rng.randint(0, cfg.vocab_size, prompt_len)
                     .astype(np.int32) for _ in range(n_requests)])
    with process_group(device):
        mesh = make_custom_mesh("1x1", device.type)
        prefill = make_prefill_step(cfg, mesh, fsdp=True)
        serve = make_serve_step(cfg, mesh, fsdp=True)
        held = prefill.shard_params(params)
        del params
        batch = prefill.local_batch(
            {"tokens": torch.from_numpy(toks).to(device)})
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(held, batch, max_seq=prompt_len + new_tokens)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gen = [tok]
        for t in range(new_tokens - 1):
            logits, cache = serve(held, cache, prompt_len + t, tok)
            tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
            gen.append(tok)
        got = torch.cat(gen, dim=1).cpu().numpy().astype(np.int32)
        t2 = time.perf_counter()
        launches = kernel_counts()
        del held, cache, logits
    torch.cuda.empty_cache()
    require(got.shape == want.shape and bool((got == want).all()),
            f"the steps' greedy tokens differ from the engine's: "
            f"{int((got != want).sum())} of {want.size}")
    return stats, t1 - t0, t2 - t1, launches


# ---------------------------------------------------------------------------
# phases 23-25: the scheduler stack (simulated Lambda time, on the host)
# ---------------------------------------------------------------------------


def run_projection(cfg, seq: int, batch_size: int, steps: int):
    """Phase 23: ``train_e2e.serverless_projection`` of a training run;
    returns (each mode's EngineResult, each mode's host seconds in
    ``EventEngine.run``)."""
    from repro_torch.examples.train_e2e import serverless_projection
    from repro_torch.serverless.events import EventEngine
    run, host_s = EventEngine.run, []

    def timed_run(self, *a, **kw):
        t0 = time.perf_counter()
        out = run(self, *a, **kw)
        host_s.append(time.perf_counter() - t0)
        return out

    EventEngine.run = timed_run
    try:
        results = serverless_projection(cfg, seq, batch_size, steps)
    finally:
        EventEngine.run = run
    require(list(results) == ["bsp", "async"], f"modes {list(results)}")
    for mode, r in results.items():
        require(r.iters_done > 0, f"{mode}: {r.iters_done} iterations")
        require(math.isfinite(r.wall_s) and math.isfinite(r.cost_usd),
                f"{mode}: wall {r.wall_s}, cost {r.cost_usd}")
        require(r.invocations >= 16, f"{mode}: {r.invocations} invocations")
    return results, dict(zip(results, host_s))


def run_quickstart(device):
    """Phase 24: the port's quickstart on the card; returns (the
    scheduler's RunResult, the kernel's max abs error, launches, s)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.examples import quickstart
    zero_counts()
    t0 = time.perf_counter()
    losses, res, err = quickstart.main(["--device", str(device)])
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    # quickstart.real_training: 40 steps of reduced olmo-1b through train()
    want = dict(want_launches(
        adamw=40 * n_leaves(reduced(ARCHS["olmo-1b"]))), aggregate_shards=1)
    log(f"  losses {losses[0]!r} -> {losses[-1]!r}; launches {launches}, "
        f"expected {want}")
    require(launches == want, f"launch counts {launches} != {want}")
    require(bool(res.config_history) and res.wall_s <= 3600.0,
            f"Scenario 1: {res.config_history}, wall {res.wall_s}")
    return res, err, launches, seconds


def golden_engine():
    from repro_torch.serverless import (WORKLOADS, EventEngine, ObjectStore,
                                        ParamStore)
    return EventEngine(WORKLOADS["resnet18"], "hier", 2, 2048, 512,
                       ParamStore(), ObjectStore(), samples=1024,
                       straggler_sigma=0.3, seed=42)


def check_golden_trace() -> int:
    """Phase 25: the port's golden engine, twice, against the checked-in
    trace byte for byte; returns its number of lines."""
    golden = (ROOT / "tests" / "golden_engine_trace.txt").read_text()
    texts = ["\n".join(golden_engine().run().trace) + "\n" for _ in range(2)]
    require(texts[0] == texts[1], "the golden trace differs between runs")
    require(texts[0] == golden, "the port's golden trace differs from "
            "tests/golden_engine_trace.txt")
    return len(golden.splitlines())


# ---------------------------------------------------------------------------
# phases 26-28: the workflow layer and the port's simlint (on the host)
# ---------------------------------------------------------------------------

# Scenario 3 of examples/deadline_budget.py at its defaults, as the JAX
# package gives it on the CPU: per task (start_s, finish_s, epochs,
# workers, dollars, granted dollars), simulated Lambda seconds and dollars
SCENARIO3 = {
    "train": (0.0, 2293.8465290137187, 4, 41, 12.408518767686587,
              27.465151862941777),
    "finetune": (2293.8465290137187, 2579.2944464492502, 1, 100,
                 4.0887497359357345, 18.394320821542276),
    "eval": (2579.2944464492502, 2976.588002717184, 1, 100,
             6.362249779341848, 23.502731496377677),
}
# and the workflow's (wall_s, ledger_usd, trace lines)
SCENARIO3_TOTALS = (2976.588002717184, 22.859518282964174, 6)
# the golden workflow trace's sweep, as the JAX package gives it: (wall_s,
# ledger_usd, trace lines, (winning trial, its loss))
HPO_GOLDEN = (1486.5402872616585, 1.4393586019392592, 51,
              (1, 0.1385806875623638))
SCOPED_RULES = ("det-raw-randomstate", "det-set-iter")


def run_scenario3():
    """Phase 26: the port's deadline_budget example with its defaults;
    returns (Scenario 3's WorkflowResult, its per-task rows, what the
    example printed, host seconds)."""
    from repro_torch.examples import deadline_budget
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        _, _, res = deadline_budget.main([])
    seconds = time.perf_counter() - t0
    rows = {}
    for name, r in res.tasks.items():
        cfg = res.config_of(name)
        rows[name] = (res.start_s[name], res.finish_s[name], r.epochs_done,
                      cfg.workers if cfg else 0, r.total_cost,
                      res.allocations[name].budget_usd)
    require(rows == SCENARIO3, f"Scenario 3's tasks {rows!r}")
    totals = (res.wall_s, res.ledger_usd, len(res.trace))
    require(totals == SCENARIO3_TOTALS, f"Scenario 3's totals {totals!r}")
    text = out.getvalue()
    require("deadline 3,600 s -> MET; budget $50.00 -> MET" in text,
            "Scenario 3 missed its goal")
    return res, rows, text, seconds


def golden_workflow_tool():
    spec = importlib.util.spec_from_file_location(
        "golden_workflow_trace", ROOT / "tools" / "golden_workflow_trace.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def check_golden_workflow():
    """Phase 27: the golden workflow trace from the port (each workflow
    run twice), byte for byte; returns (each workflow's WorkflowResult,
    lines, host seconds)."""
    tool = golden_workflow_tool()
    t0 = time.perf_counter()
    text, results = tool.golden_text("repro_torch")
    seconds = time.perf_counter() - t0
    require(text == tool.GOLDEN.read_text(), "the port's workflow trace "
            "differs from tests/golden_workflow_trace.txt")
    hpo = results["hpo"]
    got = (hpo.wall_s, hpo.ledger_usd, len(hpo.trace), hpo.winners["hpo"])
    require(got == HPO_GOLDEN, f"the sweep's results {got!r}")
    return results, len(text.splitlines()), seconds


def check_port_simlint():
    """Phase 28: the port's linter finds nothing in src/repro_torch, and its
    widened scopes fire on the known-bad fixture under the port's layers;
    returns (files linted, each scoped rule's lines, host seconds)."""
    from repro_torch.analysis import Linter
    t0 = time.perf_counter()
    linter = Linter()
    files = linter.collect([str(ROOT / "src" / "repro_torch")])
    findings = linter.lint_files(files)
    require(not findings, "simlint findings in src/repro_torch: "
            + "; ".join(f.render() for f in findings))

    def scoped(path):
        fs = Linter().lint_paths([str(path)])
        return {rule: sorted(f.line for f in fs if f.rule == rule)
                for rule in SCOPED_RULES}

    bad = (ROOT / "tests" / "lint_fixtures" / "known_bad" / "repro"
           / "serverless" / "bad_det.py")
    want = scoped(bad)
    require(all(want.values()), f"the fixture's own findings {want}")
    with tempfile.TemporaryDirectory() as tmp:
        for layer in ("serverless", "workflow"):
            dst = Path(tmp) / "repro_torch" / layer / "bad_det.py"
            dst.parent.mkdir(parents=True)
            shutil.copy(bad, dst)
            got = scoped(dst)
            require(got == want, f"repro_torch/{layer}: {got} != {want}")
    return len(files), want, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phases 32-34: tensor parallelism over a model axis of TP_RANKS ranks, each
# rank a process on the one card
# ---------------------------------------------------------------------------

TP_RANKS = 2
# NCCL refuses two ranks of one communicator on one device
# (ncclInvalidUsage); gloo takes CUDA tensors and moves them through the
# host (a 256 MB f32 all-reduce took 0.38 s on the H100 machine's host)
TP_BACKEND = "gloo"
TP_DEADLINE_S = 600          # each phase's ranks, start to finish
TP_TRAIN_BATCH = 2           # phase 32: cut from 8 so that both ranks fit
TP_TRAIN_STEPS = 3
TP_FIRST_LOSS_RTOL = 2e-3    # phase 32's first loss against world size 1
TP_LOSS_RTOL = 1e-2          # its later losses
TP_DECODE_TOKENS = 8         # phase 33: teacher-forced after the prompts
# phase 33's last-position logits against world size 1: in f32; in bf16
# the unsplit program itself lies about 2e-2 (relative norm) from its f32
# twin on random-weight olmo-1b (phase 33 prints it), so the split
# program's bf16 logits are held by their distance from the f32 twin,
# within TP_BF16_NOISE_RATIO of the unsplit bf16 program's
TP_LOGITS_REL_NORM = 1e-2
TP_BF16_NOISE_RATIO = 1.25
TP_SCORE_BATCH = 4           # phase 34
TP_SCORE_EVALS = 2           # the first held against the plain versions
TP_SCORE_RTOL = 1e-3         # phase 34's losses against world size 1
TP_SCORE_ARCHS = ("qwen2-moe-a2.7b", "mamba2-2.7b")
# phases 35-37: the hybrid, vlm and audio families on "1x2", and seq_shard.
# Phase 35 scores each at its own phase-13 / phase-21 cell, (batch, seq),
# llama-vision cut to VISION_DEPTH; phase 36 serves each in f32 after a
# prompt of its seq (zamba2's 4096 fills its 4096-slot ring, so that the
# decode wraps it), llama-vision cut to one cross group so that f32 fits
TP_FAMILY_CELLS = {"zamba2-7b": (HYBRID_BATCH, HYBRID_SEQ),
                   "llama-3.2-vision-90b": (VISION_BATCH, SEQ),
                   "seamless-m4t-medium": (GLOBAL_BATCH, SEQ)}
TP_SERVE_DEPTH = {"llama-3.2-vision-90b": 5}


def tp_family_config(arch: str, depth=None):
    """A phase 35-36 model: ARCHS[arch] at ``depth`` (default all its
    layers; llama-vision VISION_DEPTH)."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[arch]
    if depth is None and cfg.family == "vlm":
        depth = VISION_DEPTH
    return cfg if depth is None else cfg.replace(n_layers=depth)


def open_gates(params, cfg):
    """The vlm's cross gates opened to XATTN_GATE (they are zero at init,
    which would hide a broken cross layer); others as they are."""
    if cfg.family == "vlm":
        for g in ("gate_attn", "gate_mlp"):
            params["cross"][g].fill_(XATTN_GATE)
    return params


@contextlib.contextmanager
def kernel_shapes(record: dict):
    """Within the block, the shape of every ops.flash_attention call's q
    (b, h, s, d) and ops.ssd_scan call's x (b, s, h, p) is counted in
    ``record`` ({"flash": {shape: n}, "ssd": {shape: n}})."""
    from repro_torch.kernels import ops
    flash, scan = ops.flash_attention, ops.ssd_scan

    def count(kind, shape):
        d = record.setdefault(kind, {})
        d[str(tuple(shape))] = d.get(str(tuple(shape)), 0) + 1

    def flash_seen(q, k, v, **kw):
        count("flash", q.shape)
        return flash(q, k, v, **kw)

    def scan_seen(x, *args, **kw):
        count("ssd", x.shape)
        return scan(x, *args, **kw)

    ops.flash_attention, ops.ssd_scan = flash_seen, scan_seen
    try:
        yield record
    finally:
        ops.flash_attention, ops.ssd_scan = flash, scan


def tp_mesh():
    from repro_torch.launch.mesh import make_custom_mesh
    return make_custom_mesh(f"1x{TP_RANKS}", "cuda")


def tp_held(step, cfg, device):
    """Seed-0 weights drawn on the card (the world-1 phases' weights, the
    vlm's gates opened) and cut to this rank's model parts, one rank at a
    time (two whole copies of qwen2-moe and the ranks' parts would not fit
    at once)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import registry
    held = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            held = shard_leafwise(step, open_gates(
                registry.init(0, cfg, device), cfg))
            torch.cuda.empty_cache()
        dist.barrier()
    return held


def shard_leafwise(step, params):
    """``step.shard_params(params)`` for a step without ZeRO-3, done in
    place leaf by leaf, each whole leaf dropped once its part is copied:
    the peak is the whole model and one part leaf, not the whole and every
    part (llama-vision's 38.4 GB at 20 layers, beside the other rank's
    19.2, would not fit twice)."""
    from repro_torch.core import tree as T
    from repro_torch.distributed.sharding import model_part
    require(not any(step.fsdp), "shard_leafwise takes no ZeRO-3 step")
    paths = [p for p, _ in T.leaves_with_path(params)]
    for path, md in zip(paths, step.model):
        *keys, last = path.split("/")
        node = params
        for k in keys:
            node = node[k]
        if md is not None:
            node[last] = model_part(node[last], md, step.n_model,
                                    step.model_index).clone()
    return params


def tp_whole_logits(step, logits):
    """This rank's vocabulary columns -> every column (f32, on each
    rank)."""
    from repro_torch.distributed import tensor_parallel as tp
    with tp.model_parallel(step.model_group):
        return tp.gather_from_model(logits.float().contiguous(), -1)


def tp_train_rank(device, workdir, seq: bool = False):
    """Phase 32 (37 with ``seq``: seq_shard) on one rank:
    launch/train.py::train with the hier step on "1xTP_RANKS", then one
    more step of the same program under FlopCounterMode and the
    collective recorder."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ARCHS
    from repro_torch.core import tree as T
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hlo_stats import CollectiveRecorder
    from repro_torch.launch.train import train
    from repro_torch.models import registry
    from repro_torch.models.base import InputShape
    cfg = ARCHS["olmo-1b"].replace(use_flash_kernel=True, seq_shard=seq)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    shapes = {}
    with kernel_shapes(shapes):
        params, losses, step_s = train(
            cfg, steps=TP_TRAIN_STEPS, batch=TP_TRAIN_BATCH, seq=SEQ,
            strategy="hier", log_every=1, device=device,
            mesh_shape=f"1x{TP_RANKS}")
    torch.cuda.synchronize()
    out = dict(losses=losses, step_s=step_s, launches=kernel_counts(),
               routes=flash_routes(), shapes=shapes,
               peak_bytes=torch.cuda.max_memory_allocated())
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for p in T.leaves(params):
        require(bool(p.float().isfinite().all()), "non-finite parameters")
    del params
    torch.cuda.empty_cache()
    shape = InputShape(f"train_{TP_TRAIN_BATCH}x{SEQ}", SEQ,
                       TP_TRAIN_BATCH, "train")
    dcfg = D.dryrun_config("olmo-1b", shape, remat=False,
                           overrides={"seq_shard": seq})
    step = D.make_step(dcfg, shape, tp_mesh(), fsdp=False)
    args = D.step_args(step, dcfg, shape, device=device,
                       init=lambda p: registry.init(0, dcfg, device))
    with FlopCounterMode(display=False) as flops, \
            CollectiveRecorder() as rec:
        step(*args)
    torch.cuda.synchronize()
    out["flops"] = flops.get_total_flops()
    out["collectives"] = rec.stats()
    return out


def tp_serve_rank(device, workdir):
    """Phase 33 on one rank: make_prefill_step and make_serve_step on
    "1xTP_RANKS", in f32 and in bf16, the prompts then TP_DECODE_TOKENS
    teacher-forced tokens; rank 0 writes the last position's logits of
    each step (serve_logits_<dtype>.npy)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = ARCHS["olmo-1b"].replace(dtype=dtype)
        mesh = tp_mesh()
        prefill = make_prefill_step(cfg, mesh)
        serve = make_serve_step(cfg, mesh)
        held = tp_held(prefill, cfg, device)
        toks = torch.from_numpy(tp_prompts(cfg)).to(device)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(held, {"tokens": toks[:, :SEQ]},
                                max_seq=SEQ + TP_DECODE_TOKENS)
        last = [tp_whole_logits(prefill, logits[:, -1])]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(TP_DECODE_TOKENS):
            logits, cache = serve(held, cache, SEQ + t,
                                  toks[:, SEQ + t:SEQ + t + 1])
            last.append(tp_whole_logits(serve, logits[:, -1]))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        name = str(dtype).split(".")[-1]
        if dist.get_rank() == 0:
            np.save(Path(workdir) / f"serve_logits_{name}.npy",
                    torch.stack(last, 1).cpu().numpy())
        out[name] = dict(prefill_s=t1 - t0, decode_s=t2 - t1,
                         launches=kernel_counts(),
                         cache_shapes=[list(x.shape) for x in
                                       (cache["k"], cache["v"])],
                         peak_bytes=torch.cuda.max_memory_allocated())
        del held, cache, logits
        torch.cuda.empty_cache()
    return out


def tp_prompts(cfg, seq: int = SEQ):
    """Phase 33's (36's) tokens: SERVE_REQUESTS prompts of ``seq`` and the
    decode's next TP_DECODE_TOKENS, from RandomState(0)."""
    import numpy as np
    rng = np.random.RandomState(0)
    return rng.randint(0, cfg.vocab_size, (SERVE_REQUESTS, seq
                                           + TP_DECODE_TOKENS)).astype(
        np.int32)


def steps_logits(prefill, serve, params, cfg, device, seq: int,
                 whole=lambda step, x: x.float()):
    """Prefill of phase 36's prompts of ``seq`` (with the modality inputs
    of the vlm and audio models) and TP_DECODE_TOKENS teacher-forced
    serve steps: (the last position's logits of each, as ``whole`` makes
    them, (b, steps, V); the cache; prefill seconds; decode seconds)."""
    import torch
    toks = torch.from_numpy(tp_prompts(cfg, seq)).to(device)
    batch = dict(modality_inputs(cfg, SERVE_REQUESTS, seq, device),
                 tokens=toks[:, :seq])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, max_seq=seq + TP_DECODE_TOKENS)
    last = [whole(prefill, logits[:, -1])]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for t in range(TP_DECODE_TOKENS):
        logits, cache = serve(params, cache, seq + t,
                              toks[:, seq + t:seq + t + 1])
        last.append(whole(serve, logits[:, -1]))
    torch.cuda.synchronize()
    return torch.stack(last, 1), cache, t1 - t0, time.perf_counter() - t1


def tp_serve_families_rank(device, workdir):
    """Phase 36 on one rank: make_prefill_step and make_serve_step on
    "1xTP_RANKS" for each TP_FAMILY_CELLS model in f32 (llama-vision at
    TP_SERVE_DEPTH); rank 0 writes the last position's logits of each
    step (serve_logits_<arch>.npy)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import tree as T
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    out = {}
    for arch, (_, seq) in TP_FAMILY_CELLS.items():
        cfg = tp_family_config(arch, TP_SERVE_DEPTH.get(arch)).replace(
            dtype=torch.float32)
        mesh = tp_mesh()
        prefill = make_prefill_step(cfg, mesh)
        serve = make_serve_step(cfg, mesh)
        held = tp_held(prefill, cfg, device)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        last, cache, pre_s, dec_s = steps_logits(
            prefill, serve, held, cfg, device, seq, whole=tp_whole_logits)
        if dist.get_rank() == 0:
            np.save(Path(workdir) / f"serve_logits_{arch}.npy",
                    last.cpu().numpy())
        out[arch] = dict(prefill_s=pre_s, decode_s=dec_s,
                         launches=kernel_counts(),
                         cache_shapes={p: list(x.shape) for p, x in
                                       T.leaves_with_path(cache)},
                         peak_bytes=torch.cuda.max_memory_allocated())
        del held, cache, last
        torch.cuda.empty_cache()
    return out


def tp_score_rank(device, workdir, cells=None):
    """Phase 34 (35) on one rank: each model of ``cells`` (arch -> (batch,
    seq); default TP_SCORE_ARCHS at TP_SCORE_BATCH x SEQ) scored
    TP_SCORE_EVALS times on "1xTP_RANKS" (its model parts through a
    prefill step's shard_params), the first evaluation with every kernel
    call held against its plain version."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.steps import make_prefill_step
    out = {}
    cells = cells or {a: (TP_SCORE_BATCH, SEQ) for a in TP_SCORE_ARCHS}
    for arch, (batch, seq) in cells.items():
        cfg = tp_family_config(arch).replace(use_flash_kernel=True,
                                             use_ssd_kernel=True)
        step = make_prefill_step(cfg, tp_mesh())
        held = tp_held(step, cfg, device)
        torch.cuda.reset_peak_memory_stats()
        record, shapes = [], {}
        with tp.model_parallel(step.model_group), kernel_shapes(shapes):
            losses, secs, launches = run_scoring(
                cfg, step.model_params(held), device, batch, seq,
                TP_SCORE_EVALS, held=record)
        out[arch] = dict(
            losses=losses, secs=secs, launches=launches, shapes=shapes,
            routes={"flash": dict(fa.ROUTE_LAUNCHES),
                    "ssd": dict(ssd.ROUTE_LAUNCHES)},
            held=[(k, r) for k, r in record],
            peak_bytes=torch.cuda.max_memory_allocated())
        del held
        torch.cuda.empty_cache()
    return out


def local_shape(cfg, batch_size: int):
    """A rank's flash shape (b, h, s, d) on the model axis."""
    return (batch_size, cfg.n_heads // TP_RANKS, SEQ, cfg.resolved_head_dim)


def run_steps_logits(cfg, device, seq: int = SEQ):
    """Phase 33 (36) at world size 1: tp_serve_rank's calls on a one-rank
    mesh; returns (the last position's logits of each step, (b, steps, V)
    f32 numpy, prefill seconds, decode seconds, the cache's shapes)."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.launch.mesh import make_custom_mesh, process_group
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import registry
    params = open_gates(registry.init(0, cfg, device), cfg)
    with process_group(device):
        mesh = make_custom_mesh("1x1", device.type)
        last, cache, pre_s, dec_s = steps_logits(
            make_prefill_step(cfg, mesh), make_serve_step(cfg, mesh),
            params, cfg, device, seq)
        out = last.cpu().numpy()
        shapes = {p: list(x.shape) for p, x in T.leaves_with_path(cache)}
        del params, cache, last
    torch.cuda.empty_cache()
    return out, pre_s, dec_s, shapes


# phase 37b: a model whose whole leaves are read on the sequence slice
# (olmo-1b's layer norms carry no scale, so phase 37 reads none and its
# losses cannot show the sum of their partial gradients): zamba2-7b at full
# width, cut to one group of attn_every Mamba2 layers and the shared
# block, in f32 without the kernels. Each whole leaf's first gradient (the
# norm scales, the SSM layers' wB / wC / conv_BC) is held against world
# size 1's by its relative norm, far below the ~1/2 that a rank's partial
# gradient lies from the whole
SEQ_LEAF_ARCH = "zamba2-7b"
SEQ_LEAF_BATCH = 2
SEQ_LEAF_GRAD_REL = 1e-3


def seq_leaf_setup(device):
    """Phase 37b's config (seq_shard on) and its batch of SEQ_LEAF_BATCH
    x SEQ tokens from RandomState(0), the labels the tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    cfg = ARCHS[SEQ_LEAF_ARCH]
    cfg = cfg.replace(n_layers=cfg.attn_every, dtype=torch.float32,
                      seq_shard=True)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (SEQ_LEAF_BATCH, SEQ)).astype(np.int32)).to(
        device)
    return cfg, {"tokens": toks, "labels": toks}


def seq_leaf_run(step, params, batch, paths=None):
    """The batch's loss and gradient on ``step``, then TP_TRAIN_STEPS steps
    on it from a fresh AdamW state: (the gradient of each leaf of
    ``paths``, default every leaf the step holds whole, as f32 numpy; the
    steps' losses)."""
    from repro_torch.core import tree as T
    _, grads = step.loss_and_grads(params, batch)
    whole = {p: g.float().cpu().numpy() for (p, g), md in
             zip(T.leaves_with_path(grads), step.model)
             if (md is None if paths is None else p in paths)}
    del grads
    opt, losses = step.init_opt_state(params), []
    for _ in range(TP_TRAIN_STEPS):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return whole, losses


def tp_seq_leaf_rank(device, workdir):
    """Phase 37b on one rank: seq_leaf_run on "1xTP_RANKS" with this
    rank's model parts; the whole leaves' gradients into
    DIR/seq_leaves_rank<r>.npz."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.steps import make_train_step
    cfg, batch = seq_leaf_setup(device)
    step = make_train_step(cfg, tp_mesh(), strategy="hier")
    held = tp_held(step, cfg, device)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    whole, losses = seq_leaf_run(step, held, step.local_batch(batch))
    np.savez(Path(workdir) / f"seq_leaves_rank{dist.get_rank()}.npz",
             **whole)
    return dict(losses=losses, launches=kernel_counts(),
                peak_bytes=torch.cuda.max_memory_allocated())


def check_seq_leaves(device, tp_note: str):
    """Phase 37b: tp_seq_leaf_rank's ranks against seq_leaf_run at world
    size 1: every whole leaf's gradient within SEQ_LEAF_GRAD_REL (relative
    norm), the losses within TP_SCORE_RTOL, no kernel launch."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_custom_mesh, process_group
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import registry
    cfg, batch = seq_leaf_setup(device)
    log(f"[37b] seq_shard with whole leaves read on the slice: "
        f"{cfg.arch_id} at full width, {cfg.n_layers} Mamba2 layers and "
        f"the shared block, f32 without the kernels (seed 0), batch "
        f"{SEQ_LEAF_BATCH} x {SEQ}: the first gradient of every leaf each "
        f"rank holds whole, then {TP_TRAIN_STEPS} hier steps, on "
        f"1x{TP_RANKS} against world size 1; {tp_note}")
    t0 = time.perf_counter()
    tr, tr_dir = run_tp_world("seq_leaves")
    grads = [dict(np.load(Path(tr_dir) / f"seq_leaves_rank{r}.npz"))
             for r in range(TP_RANKS)]
    shutil.rmtree(tr_dir, ignore_errors=True)
    log(f"  the ranks' phase took {time.perf_counter() - t0:.1f} s")
    paths = sorted(grads[0])
    require(any(p.endswith("ln/scale") for p in paths)
            and any(p.endswith("/wB") for p in paths)
            and "final_norm/scale" in paths,
            f"phase 37b's whole leaves {paths}: no norm scale or wB")
    params = registry.init(0, cfg, device)
    with process_group(device):
        step = make_train_step(cfg, make_custom_mesh("1x1", device.type),
                               strategy="hier")
        w_grads, w_losses = seq_leaf_run(step, params, batch, set(paths))
    del params, step
    torch.cuda.empty_cache()
    for rank, (r, g) in enumerate(zip(tr, grads)):
        require(sorted(g) == paths, f"rank {rank}'s whole leaves {sorted(g)}")
        rels = {p: float(np.linalg.norm(g[p] - w_grads[p])
                         / max(float(np.linalg.norm(w_grads[p])), 1e-30))
                for p in paths}
        errs = [abs(a - b) / abs(b) for a, b in zip(r["losses"], w_losses)]
        log(f"  rank {rank}: whole leaves' gradients against world size 1 "
            f"(relative norm, limit {SEQ_LEAF_GRAD_REL}): {rels}; losses "
            f"{r['losses']} against {w_losses} (relative {errs}, limit "
            f"{TP_SCORE_RTOL}); peak {r['peak_bytes']} bytes "
            f"({r['peak_bytes'] / 2**30:.2f} GiB), launches {r['launches']}")
        require(max(rels.values()) <= SEQ_LEAF_GRAD_REL,
                f"rank {rank}'s whole-leaf gradients off: {rels}")
        require(max(errs) <= TP_SCORE_RTOL,
                f"rank {rank}'s losses {r['losses']} against {w_losses}")
        want = want_launches(adamw=TP_TRAIN_STEPS * n_leaves(cfg))
        require(r["launches"] == want,
                f"rank {rank} launched {r['launches']}: the f32 step with "
                f"the kernels off launches only AdamW's, {want}")


TP_TASKS = {"train": tp_train_rank, "serve": tp_serve_rank,
            "score": tp_score_rank,
            "score_families": lambda device, workdir: tp_score_rank(
                device, workdir, TP_FAMILY_CELLS),
            "serve_families": tp_serve_families_rank,
            "train_seq": lambda device, workdir: tp_train_rank(
                device, workdir, seq=True),
            "seq_leaves": tp_seq_leaf_rank}


def tp_rank_main(task: str, rank: int, world: int, workdir: str) -> int:
    """One rank of a phase 32-34 task (``chip_smoke.py --tp-rank TASK RANK
    WORLD DIR``): a TP_BACKEND process group through DIR, cuda:0, the
    kernels this script's build made; the result as DIR/TASK_rankR.json."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    dist.init_process_group(TP_BACKEND,
                            init_method=f"file://{workdir}/{task}.init",
                            rank=rank, world_size=world)
    try:
        out = TP_TASKS[task](torch.device("cuda", 0), workdir)
        with open(Path(workdir) / f"{task}_rank{rank}.json", "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def run_tp_world(task: str):
    """Phases 32-34: TP_RANKS processes of this script running ``task``,
    all on cuda:0, under one deadline; every rank is killed if one fails
    or the deadline passes, and the phase raises with each rank's log.
    Returns (each rank's result, the directory the ranks wrote, which the
    caller removes)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix=f"chip_smoke_tp_{task}_")
    procs, logs = [], []
    for rank in range(TP_RANKS):
        log_f = open(Path(workdir) / f"{task}_rank{rank}.log", "w+")
        logs.append(log_f)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--tp-rank",
             task, str(rank), str(TP_RANKS), workdir],
            stdout=log_f, stderr=subprocess.STDOUT, cwd=ROOT))
    deadline = time.monotonic() + TP_DEADLINE_S
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"timed out after {TP_DEADLINE_S} s"
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is None and any(p.returncode for p in procs):
        failed = f"exit codes {[p.returncode for p in procs]}"
    texts = []
    for rank, f in enumerate(logs):
        f.seek(0)
        texts.append(f"--- rank {rank} ---\n{f.read()[-6000:]}")
        f.close()
    if failed:
        raise RuntimeError(f"phase task {task!r} on {TP_RANKS} ranks: "
                           f"{failed}\n" + "\n".join(texts))
    results = []
    for rank in range(TP_RANKS):
        with open(Path(workdir) / f"{task}_rank{rank}.json") as f:
            results.append(json.load(f))
    return results, workdir


def check_tp_scores(cells: dict, sc: list, w_score: dict,
                    tp_note: str) -> dict:
    """Phases 34 and 35: each rank's scoring of each model of ``cells``
    (arch -> (cfg, batch, seq)) against world size 1's (``w_score``: arch
    -> run_scoring's result): losses within TP_SCORE_RTOL, exact launch
    counts, all on wgmma, at the local kernel shapes, and the first
    evaluation's every kernel call held. Returns each arch's measured
    launches of each kernel, summed over the ranks."""
    tp_launches = {}
    for arch, (c, batch, seq) in cells.items():
        w_losses = w_score[arch][0]
        kinds = {}
        if attention_sites(c):
            kinds["flash"] = ("flash_attention", attention_sites(c), str((
                batch, c.n_heads // TP_RANKS, seq, c.resolved_head_dim)))
        if c.family in ("ssm", "hybrid"):
            kinds["ssd"] = ("ssd_scan", c.n_layers, str((
                batch, seq, c.ssm_nheads // TP_RANKS, c.ssm_headdim)))
        want = want_launches(**{k: n * TP_SCORE_EVALS
                                for k, (_, n, _) in kinds.items()})
        local = {k: {shape: want[key]} for k, (key, _, shape)
                 in kinds.items()}
        for rank, res in enumerate(sc):
            r = res[arch]
            errs = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                        w_losses)]
            held = max(x for _, x in r["held"])
            log(f"  {arch} rank {rank}: losses {r['losses']} against world "
                f"size 1's {w_losses} (relative {errs}, tolerance "
                f"{TP_SCORE_RTOL}); seconds {r['secs']} against "
                f"{w_score[arch][1]} ({tp_note}); peak {r['peak_bytes']} "
                f"bytes ({r['peak_bytes'] / 2**30:.2f} GiB); launches "
                f"{r['launches']}, routes {r['routes']}, shapes "
                f"{r['shapes']}; {len(r['held'])} kernel calls held against "
                f"plain, worst relative norm error {held:.3e}")
            require(max(errs) <= TP_SCORE_RTOL,
                    f"{arch} rank {rank}'s losses {r['losses']} against "
                    f"{w_losses}")
            require(r["launches"] == want,
                    f"{arch} rank {rank}'s launches {r['launches']} != {want}")
            for kind, (key, _, _) in kinds.items():
                require(r["routes"][kind] == {"wgmma": want[key],
                                              "cuda_cores": 0},
                        f"{arch} rank {rank}'s {kind} routes {r['routes']}")
            require(r["shapes"] == local,
                    f"{arch} rank {rank}'s kernel shapes {r['shapes']}, "
                    f"want {local}")
            n = sum(want[key] for key, _, _ in kinds.values())
            require(len(r["held"]) == n // TP_SCORE_EVALS,
                    f"{arch} rank {rank}: {len(r['held'])} calls held")
            got = tp_launches.setdefault(arch, {})
            for key, _, _ in kinds.values():
                got[key] = got.get(key, 0) + r["launches"][key]
    return tp_launches


def run_tp_phases(device, gen, card: str, flash_rows: list,
                  ssd_rows: list):
    """Phases 32-34: tensor parallelism on a model axis of TP_RANKS, each
    held against the same work at world size 1; the local-head kernel
    shapes' rows go into ``flash_rows`` and ``ssd_rows``."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun as D
    from repro_torch.models import registry
    from repro_torch.models.base import InputShape
    tp_note = (f"{TP_RANKS} ranks sharing one {card} through "
               f"{TP_BACKEND}; not tensor-parallel speed")
    tcfg = ARCHS["olmo-1b"].replace(use_flash_kernel=True)
    log(f"[32] tensor parallelism: {tcfg.arch_id} bf16 (seed 0) through "
        f"launch/train.py::train with the hier step on 1x{TP_RANKS} "
        f"(model axis {TP_RANKS}), batch {TP_TRAIN_BATCH} x {SEQ} (cut from "
        f"{GLOBAL_BATCH} so that both ranks fit), {TP_TRAIN_STEPS} steps, "
        f"against the same steps at world size 1; {tp_note}")
    w_losses, w_step_s, _, _, w_peak = run_hier_training(
        tcfg, device, TP_TRAIN_BATCH, SEQ, TP_TRAIN_STEPS)
    w_losses32 = w_losses
    t0 = time.perf_counter()
    tr, tr_dir = run_tp_world("train")
    shutil.rmtree(tr_dir, ignore_errors=True)
    log(f"  world size 1: losses {w_losses}, step seconds {w_step_s}, peak "
        f"{w_peak} bytes; the ranks' phase took "
        f"{time.perf_counter() - t0:.1f} s")
    want = want_launches(flash=tcfg.n_layers * TP_TRAIN_STEPS,
                         flash_bwd=tcfg.n_layers * TP_TRAIN_STEPS,
                         adamw=TP_TRAIN_STEPS * n_leaves(tcfg))
    local = (TP_TRAIN_BATCH, tcfg.n_heads // TP_RANKS, SEQ,
             tcfg.resolved_head_dim)
    for rank, r in enumerate(tr):
        errs = [abs(a - b) / abs(b) for a, b in zip(r["losses"], w_losses)]
        log(f"  rank {rank}: losses {r['losses']} (relative to world size "
            f"1: {errs}; tolerances {TP_FIRST_LOSS_RTOL} first, "
            f"{TP_LOSS_RTOL} later), step seconds {r['step_s']} ({tp_note}),"
            f" peak {r['peak_bytes']} bytes ({r['peak_bytes'] / 2**30:.2f} "
            f"GiB), launches {r['launches']}, flash routes {r['routes']}, "
            f"shapes {r['shapes']}")
        require(errs[0] <= TP_FIRST_LOSS_RTOL and max(errs) <= TP_LOSS_RTOL,
                f"rank {rank}'s losses {r['losses']} against {w_losses}")
        require(r["launches"] == want, f"rank {rank}'s launches "
                f"{r['launches']} != {want}")
        require_wgmma(r["routes"], want, f"rank {rank}")
        require(r["shapes"] == {"flash": {str(local):
                                          want["flash_attention"]}},
                f"rank {rank}'s flash shapes {r['shapes']}, want {local}")
    shape = InputShape(f"train_{TP_TRAIN_BATCH}x{SEQ}", SEQ, TP_TRAIN_BATCH,
                       "train")
    pred = D.lower_one("olmo-1b", shape, multi_pod=False,
                       mesh_shape=f"1x{TP_RANKS}", fsdp=False, remat=False,
                       device=device.type)
    log(f"  the dry run of rank 0's step on 1x{TP_RANKS} (fake CUDA tensors,"
        f" trace {pred['trace_s']} s): flops {pred['flops']!r}, collectives "
        f"{pred['collectives']}, memory {pred['memory']}; measured on rank "
        f"0: flops {tr[0]['flops']!r}")
    require(pred["flops"] == tr[0]["flops"],
            f"predicted flops {pred['flops']!r} != rank 0's "
            f"{tr[0]['flops']!r}")

    log(f"[33] the prefill and serve steps on 1x{TP_RANKS}: "
        f"{tcfg.arch_id} in f32 and in bf16 (seed 0), {SERVE_REQUESTS} "
        f"prompts of {SEQ}, then {TP_DECODE_TOKENS} teacher-forced tokens, "
        f"against the same steps at world size 1; {tp_note}")
    w_steps = {name: run_steps_logits(ARCHS["olmo-1b"].replace(dtype=dt),
                                      device)
               for name, dt in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16))}
    sv, sv_dir = run_tp_world("serve")
    t_logits = {name: np.load(Path(sv_dir) / f"serve_logits_{name}.npy")
                for name in w_steps}
    shutil.rmtree(sv_dir, ignore_errors=True)

    def rel_norms(a, b):
        return [float(np.linalg.norm(a[:, i] - b[:, i])
                      / np.linalg.norm(b[:, i])) for i in range(b.shape[1])]
    vocab = ARCHS["olmo-1b"].vocab_size
    f32, bf16 = w_steps["float32"][0], w_steps["bfloat16"][0]
    rels = rel_norms(t_logits["float32"], f32)
    tp_vs_w = rel_norms(t_logits["bfloat16"], bf16)
    tp_vs_f32 = rel_norms(t_logits["bfloat16"], f32)
    w_vs_f32 = rel_norms(bf16, f32)
    for name, (w_logits, w_pre_s, w_dec_s, _) in w_steps.items():
        agree = float(np.mean(t_logits[name][..., :vocab].argmax(-1)
                              == w_logits[..., :vocab].argmax(-1)))
        log(f"  {name}: greedy tokens agree at {agree!r} of "
            f"{w_logits.shape[0] * w_logits.shape[1]} positions; world size "
            f"1: prefill {w_pre_s!r} s, decode {w_dec_s!r} s; "
            + "; ".join(f"rank {k}: prefill {r[name]['prefill_s']!r} s, "
                        f"decode {r[name]['decode_s']!r} s, cache (k, v) "
                        f"{r[name]['cache_shapes']}, peak "
                        f"{r[name]['peak_bytes']} bytes, launches "
                        f"{r[name]['launches']}" for k, r in enumerate(sv))
            + f" ({tp_note})")
        for r in sv:
            require(r[name]["launches"] == want_launches(), "the steps' "
                    f"launches {r[name]['launches']}: prefill attends "
                    "through its cache")
    log(f"  f32 last-position logits against world size 1, relative norm "
        f"per step (prefill, then each decode): {rels} (limit "
        f"{TP_LOGITS_REL_NORM})")
    log(f"  bf16: against world size 1's bf16 {tp_vs_w}; against world size "
        f"1's f32 {tp_vs_f32}, where world size 1's bf16 lies {w_vs_f32} "
        f"from it (the split program's distance within "
        f"{TP_BF16_NOISE_RATIO} times the unsplit one's)")
    require(max(rels) <= TP_LOGITS_REL_NORM,
            f"tensor-parallel f32 logits off by {max(rels)!r}")
    for i, (a, b) in enumerate(zip(tp_vs_f32, w_vs_f32)):
        require(a <= TP_BF16_NOISE_RATIO * b,
                f"step {i}: the split bf16 logits lie {a!r} from f32, the "
                f"unsplit ones {b!r}")

    log(f"[34] scoring on 1x{TP_RANKS}: {', '.join(TP_SCORE_ARCHS)} at full "
        f"width in bf16 (seed 0), batch {TP_SCORE_BATCH} x {SEQ}, "
        f"{TP_SCORE_EVALS} evaluations (the first with every kernel call "
        f"held against its plain version), against world size 1; "
        f"{tp_note}")
    w_score = {}
    for arch in TP_SCORE_ARCHS:
        c = ARCHS[arch].replace(use_flash_kernel=True, use_ssd_kernel=True)
        params = registry.init(0, c, device)
        w_score[arch] = run_scoring(c, params, device, TP_SCORE_BATCH, SEQ,
                                    TP_SCORE_EVALS)
        del params
        torch.cuda.empty_cache()
    sc, sc_dir = run_tp_world("score")
    shutil.rmtree(sc_dir, ignore_errors=True)
    tp_launches = check_tp_scores(
        {a: (ARCHS[a], TP_SCORE_BATCH, SEQ) for a in TP_SCORE_ARCHS}, sc,
        w_score, tp_note)
    ssm = ARCHS["mamba2-2.7b"]
    qwen = ARCHS["qwen2-moe-a2.7b"]
    tp_flash_shapes = [
        (f"{tcfg.arch_id} (1x{TP_RANKS} rank)", local_shape(tcfg,
                                                            TP_TRAIN_BATCH),
         0),
        (f"{qwen.arch_id} (1x{TP_RANKS} rank)", local_shape(qwen,
                                                            TP_SCORE_BATCH),
         0)]
    tp_ssd_shape = (TP_SCORE_BATCH, SEQ, ssm.ssm_nheads // TP_RANKS,
                    ssm.ssm_headdim, ssm.ssm_state, min(ssm.ssm_chunk, SEQ))
    log(f"  the local-head kernel shapes against their plain versions and "
        f"timed (as in phase 6; {card})")
    tp_errs = check_flash_shapes(device, tp_flash_shapes, gen)
    tp_ssd_err = check_ssd_shape(device, tp_ssd_shape, gen,
                                 f"{ssm.arch_id} (1x{TP_RANKS} rank)")
    tp_counts = {tp_flash_shapes[0][0]: sum(
                     r["launches"]["flash_attention"] for r in tr),
                 tp_flash_shapes[1][0]:
                 tp_launches[qwen.arch_id]["flash_attention"]}
    for name, shape, window in tp_flash_shapes:
        t = time_flash(device, shape, gen, window=window)
        flash_rows.append(dict(model=name, shape=list(shape), window=window,
                               launches=tp_counts[name],
                               max_abs_err=tp_errs[name], **t))
        log(f"  flash_attention at {name}'s shape: {flash_rows[-1]}")
    t, cc_ms = time_ssd(device, tp_ssd_shape, gen)
    ssd_rows.append(dict(model=f"{ssm.arch_id} (1x{TP_RANKS} rank)",
                         shape=list(tp_ssd_shape),
                         launches=tp_launches[ssm.arch_id]["ssd_scan"],
                         max_abs_err=tp_ssd_err, cuda_cores_ms=cc_ms, **t))
    log(f"  ssd_scan at {ssm.arch_id}'s local shape: {ssd_rows[-1]}")
    return dict(w_losses=w_losses32, peaks=[r["peak_bytes"] for r in tr],
                collectives=pred["collectives"], tp_note=tp_note,
                bwd_launches=sum(r["launches"]["flash_attention_bwd"]
                                 for r in tr))


def run_tp_family_phases(device, gen, card: str, flash_rows: list,
                         ssd_rows: list, p32: dict):
    """Phases 35-37: the hybrid, vlm and audio families on "1xTP_RANKS"
    (scoring in bf16 and the prefill and serve steps in f32, each against
    world size 1), then phase 32's training under seq_shard; the local
    kernel shapes' rows go into ``flash_rows`` and ``ssd_rows``."""
    import numpy as np
    import torch
    from repro_torch.launch import dryrun as D
    from repro_torch.models import registry
    from repro_torch.models.base import InputShape
    tp_note = p32["tp_note"]
    cells = {a: (tp_family_config(a).replace(use_flash_kernel=True,
                                             use_ssd_kernel=True), b, s)
             for a, (b, s) in TP_FAMILY_CELLS.items()}
    log(f"[35] scoring on 1x{TP_RANKS} in bf16 (seed 0): "
        + "; ".join(f"{a} {c.n_layers} layers, {b} x {s}" for a, (c, b, s)
                    in cells.items())
        + f" (the vlm's gates opened to {XATTN_GATE} on both sides), "
        f"{TP_SCORE_EVALS} evaluations (the first with every kernel call "
        f"held against its plain version), against world size 1; "
        f"{tp_note}")
    w_score = {}
    for arch, (c, b, s) in cells.items():
        params = open_gates(registry.init(0, c, device), c)
        w_score[arch] = run_scoring(c, params, device, b, s, TP_SCORE_EVALS)
        del params
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sc, sc_dir = run_tp_world("score_families")
    shutil.rmtree(sc_dir, ignore_errors=True)
    log(f"  the ranks' phase took {time.perf_counter() - t0:.1f} s")
    tp_launches = check_tp_scores(cells, sc, w_score, tp_note)

    serve = {a: tp_family_config(a, TP_SERVE_DEPTH.get(a)).replace(
        dtype=torch.float32) for a in TP_FAMILY_CELLS}
    log(f"[36] the prefill and serve steps on 1x{TP_RANKS} in f32 (seed 0): "
        + "; ".join(f"{a} {serve[a].n_layers} layers, {SERVE_REQUESTS} "
                    f"prompts of {s}" for a, (_, s) in TP_FAMILY_CELLS.items())
        + f", then {TP_DECODE_TOKENS} teacher-forced tokens, against the "
        f"same steps at world size 1; {tp_note}")
    w_steps = {a: run_steps_logits(serve[a], device, s)
               for a, (_, s) in TP_FAMILY_CELLS.items()}
    t0 = time.perf_counter()
    sv, sv_dir = run_tp_world("serve_families")
    t_logits = {a: np.load(Path(sv_dir) / f"serve_logits_{a}.npy")
                for a in w_steps}
    shutil.rmtree(sv_dir, ignore_errors=True)
    log(f"  the ranks' phase took {time.perf_counter() - t0:.1f} s")
    for arch, (w_logits, w_pre_s, w_dec_s, w_shapes) in w_steps.items():
        got = t_logits[arch]
        rels = [float(np.linalg.norm(got[:, i] - w_logits[:, i])
                      / np.linalg.norm(w_logits[:, i]))
                for i in range(w_logits.shape[1])]
        v = serve[arch].vocab_size
        agree = float(np.mean(got[..., :v].argmax(-1)
                              == w_logits[..., :v].argmax(-1)))
        log(f"  {arch}: last-position logits against world size 1, relative "
            f"norm per step (prefill, then each decode): {rels} (limit "
            f"{TP_LOGITS_REL_NORM}); greedy tokens agree at {agree!r} of "
            f"{w_logits.shape[0] * w_logits.shape[1]} positions; world size "
            f"1: prefill {w_pre_s!r} s, decode {w_dec_s!r} s, cache "
            f"{w_shapes}")
        for k, r in enumerate(sv):
            r = r[arch]
            log(f"  {arch} rank {k}: prefill {r['prefill_s']!r} s, decode "
                f"{r['decode_s']!r} s, cache (the rank's part) "
                f"{r['cache_shapes']}, peak {r['peak_bytes']} bytes "
                f"({r['peak_bytes'] / 2**30:.2f} GiB), launches "
                f"{r['launches']} ({tp_note})")
            require(r["launches"] == want_launches(),
                    f"{arch}'s steps launched {r['launches']}: the f32 "
                    "steps run no kernel")
            for path, whole in w_shapes.items():
                part = r["cache_shapes"][path]
                split = [i for i, (a, b) in enumerate(zip(part, whole))
                         if a != b]
                require(part == whole if path.endswith("conv_BC") else
                        len(split) == 1 and part[split[0]] * TP_RANKS
                        == whole[split[0]],
                        f"{arch} rank {k}'s cache {path} {part}: not a "
                        f"model part of {whole}")
        require(max(rels) <= TP_LOGITS_REL_NORM,
                f"{arch}'s tensor-parallel f32 logits off by {max(rels)!r}")

    log(f"[37] phase 32 under seq_shard: olmo-1b bf16 (seed 0) through "
        f"launch/train.py::train with the hier step on 1x{TP_RANKS}, batch "
        f"{TP_TRAIN_BATCH} x {SEQ}, {TP_TRAIN_STEPS} steps, the stream split "
        f"along the sequence between the layers, against phase 32's world "
        f"size 1 losses; {tp_note}")
    t0 = time.perf_counter()
    tr, tr_dir = run_tp_world("train_seq")
    shutil.rmtree(tr_dir, ignore_errors=True)
    log(f"  the ranks' phase took {time.perf_counter() - t0:.1f} s")
    w_losses = p32["w_losses"]
    olmo = tp_family_config("olmo-1b")
    want = want_launches(flash=olmo.n_layers * TP_TRAIN_STEPS,
                         flash_bwd=olmo.n_layers * TP_TRAIN_STEPS,
                         adamw=TP_TRAIN_STEPS * n_leaves(olmo))
    local = (TP_TRAIN_BATCH, olmo.n_heads // TP_RANKS, SEQ,
             olmo.resolved_head_dim)
    for rank, r in enumerate(tr):
        errs = [abs(a - b) / abs(b) for a, b in zip(r["losses"], w_losses)]
        log(f"  rank {rank}: losses {r['losses']} (relative to world size "
            f"1: {errs}; tolerances {TP_FIRST_LOSS_RTOL} first, "
            f"{TP_LOSS_RTOL} later), step seconds {r['step_s']} ({tp_note}),"
            f" peak {r['peak_bytes']} bytes ({r['peak_bytes'] / 2**30:.2f} "
            f"GiB; phase 32's {p32['peaks'][rank] / 2**30:.2f} GiB), "
            f"launches {r['launches']}, flash routes {r['routes']}, shapes "
            f"{r['shapes']}")
        require(errs[0] <= TP_FIRST_LOSS_RTOL and max(errs) <= TP_LOSS_RTOL,
                f"rank {rank}'s losses {r['losses']} against {w_losses}")
        require(r["launches"] == want, f"rank {rank}'s launches "
                f"{r['launches']} != {want}")
        require_wgmma(r["routes"], want, f"rank {rank}")
        require(r["shapes"] == {"flash": {str(local):
                                          want["flash_attention"]}},
                f"rank {rank}'s flash shapes {r['shapes']}, want {local}")
    shape = InputShape(f"train_{TP_TRAIN_BATCH}x{SEQ}", SEQ, TP_TRAIN_BATCH,
                       "train")
    pred = D.lower_one("olmo-1b", shape, multi_pod=False,
                       mesh_shape=f"1x{TP_RANKS}", fsdp=False, remat=False,
                       overrides={"seq_shard": True}, device=device.type)
    coll, plain = tr[0]["collectives"], p32["collectives"]
    log(f"  the dry run of rank 0's step on 1x{TP_RANKS} under seq_shard "
        f"(fake CUDA tensors, trace {pred['trace_s']} s): flops "
        f"{pred['flops']!r}, collectives {pred['collectives']}, memory "
        f"{pred['memory']}; measured on rank 0: flops {tr[0]['flops']!r}, "
        f"collectives {coll}; phase 32's step without seq_shard: "
        f"collectives {plain}")
    require(pred["flops"] == tr[0]["flops"],
            f"predicted flops {pred['flops']!r} != rank 0's "
            f"{tr[0]['flops']!r}")
    require(pred["collectives"] == coll, "the dry run's collectives "
            f"{pred['collectives']} != rank 0's {coll}")
    # each layer's two model-group all-reduces forward and two backward
    # become as many reduce-scatter / all-gather pairs
    pairs = 4 * olmo.n_layers
    count = lambda c, op: c.get(op, {}).get("count", 0)  # noqa: E731
    require(count(plain, "all-reduce") - count(coll, "all-reduce") >= pairs
            and count(coll, "reduce-scatter")
            - count(plain, "reduce-scatter") >= pairs
            and count(coll, "all-gather") - count(plain, "all-gather")
            >= pairs, f"seq_shard's collectives {coll} against {plain}: "
            f"want {pairs} per-layer all-reduces as reduce-scatter / "
            "all-gather pairs")
    row32 = next(r for r in flash_rows
                 if r["model"] == f"{olmo.arch_id} (1x{TP_RANKS} rank)")
    row32["launches"] += sum(r["launches"]["flash_attention"] for r in tr)
    p32["seq_bwd_launches"] = sum(r["launches"]["flash_attention_bwd"]
                                  for r in tr)
    check_seq_leaves(device, tp_note)

    hyb, vis, aud = (cells[a][0] for a in TP_FAMILY_CELLS)
    shapes = [(f"{c.arch_id} (1x{TP_RANKS} rank)",
               (b, c.n_heads // TP_RANKS, s, c.resolved_head_dim),
               c.sliding_window) for c, b, s in cells.values()]
    hb, hs = TP_FAMILY_CELLS[hyb.arch_id]
    ssd_shape = (hb, hs, hyb.ssm_nheads // TP_RANKS, hyb.ssm_headdim,
                 hyb.ssm_state, min(hyb.ssm_chunk, hs))
    log(f"  the local-head kernel shapes of phase 35 against their plain "
        f"versions and timed (as in phase 6; {card})")
    errs = check_flash_shapes(device, shapes, gen)
    ssd_name = f"{hyb.arch_id} (1x{TP_RANKS} rank)"
    ssd_err = check_ssd_shape(device, ssd_shape, gen, ssd_name)
    for (name, shape, window), c in zip(shapes, (hyb, vis, aud)):
        t = time_flash(device, shape, gen, window=window)
        flash_rows.append(dict(
            model=name, shape=list(shape), window=window,
            launches=tp_launches[c.arch_id]["flash_attention"],
            max_abs_err=errs[name], **t))
        log(f"  flash_attention at {name}'s shape: {flash_rows[-1]}")
    t, cc_ms = time_ssd(device, ssd_shape, gen)
    ssd_rows.append(dict(model=ssd_name, shape=list(ssd_shape),
                         launches=tp_launches[hyb.arch_id]["ssd_scan"],
                         max_abs_err=ssd_err, cuda_cores_ms=cc_ms, **t))
    log(f"  ssd_scan at {ssd_name}'s shape: {ssd_rows[-1]}")



# ---------------------------------------------------------------------------
# phase 38: the flash backward against its plain version, timed
# ---------------------------------------------------------------------------

# ||got - want|| / ||want|| of each bf16 gradient against the plain
# backward: P and dS are rounded to bf16 for the products, where the
# forward rounds only P (FLASH_BF16_REL_NORM)
FLASH_BWD_BF16_REL_NORM = 1e-2
# phase 3's sweep for the backward: (seq, causal, window) at (2, 4, s, d)
# for every head dim, 160 not a multiple of any tile
FLASH_BWD_SWEEP = ((128, True, 0), (160, True, 0), (384, True, 16),
                   (384, True, 64), (384, True, 100), (256, False, 0))


def bwd_case(shape, dtype, gen, device, causal: bool = True,
             window: int = 0):
    """q, k, v on the model's (b, s, h, d) views, the kernel forward's
    output and lse, and dO in the output's layout (the model's
    out.transpose(1, 2).reshape(b, s, h * d) @ wo hands it so)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = bshd_views(shape, dtype, gen, device)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    g = bshd_views(shape, dtype, gen, device)[0]
    return q, k, v, out, lse, g


def hold_bwd(got, want, what: str):
    """dq, dk, dv against the plain ones: f32 rtol 5e-4 / atol 1e-5, bf16
    2e-2 / 2e-2 and each within FLASH_BWD_BF16_REL_NORM; returns (max abs
    error, worst relative norm error)."""
    import torch
    err, rel = 0.0, 0.0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        bf16 = a.dtype == torch.bfloat16
        err = max(err, require_close(a, w, *((2e-2, 2e-2) if bf16
                                             else (5e-4, 1e-5)),
                                     f"{what} {name}"))
        r = rel_norm_err(a, w)
        rel = max(rel, r)
        require(not bf16 or r < FLASH_BWD_BF16_REL_NORM, f"{what} {name}: "
                f"relative norm error {r:.3e} >= {FLASH_BWD_BF16_REL_NORM}")
    return err, rel


def check_flash_bwd(device, gen, shapes) -> dict:
    """The backward kernels against plain_flash_attention_bwd: the sweep on
    both routes and every head dim, one padded length through
    ops.flash_attention's autograd against the plain forward's, and the
    bf16 ``shapes`` ((name, shape, window)) with two calls bit-equal.
    Returns each shape's (max abs error, relative norm error)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    routes = dict(fa.BWD_ROUTE_LAUNCHES)
    rels = []
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in fa.HEAD_DIMS:
            for seq, causal, window in FLASH_BWD_SWEEP:
                case = bwd_case((2, 4, seq, d), dtype, gen, device, causal,
                                window)
                what = (f"flash bwd {dtype} d={d} seq={seq} causal={causal} "
                        f"window={window}")
                require_close(case[4], fa.plain_flash_lse(
                    *case[:2], causal=causal, window=window), 1e-5, 1e-5,
                    f"{what} lse")
                got = fa.flash_attention_bwd(*case, causal=causal,
                                             window=window)
                rels.append(hold_bwd(got, fa.plain_flash_attention_bwd(
                    *case, causal=causal, window=window), what)[1])
                n += 1
        q, k, v = [x.detach().requires_grad_(True) for x in
                   bshd_views((2, 4, 200, 64), dtype, gen, device)]
        g = bshd_views((2, 4, 200, 64), dtype, gen, device)[0]
        out = ops.flash_attention(q, k, v, causal=True, window=48,
                                  block_q=64, block_k=64)
        got = torch.autograd.grad(out, (q, k, v), g)
        want = torch.autograd.grad(fa.plain_flash_attention(
            q, k, v, causal=True, window=48), (q, k, v), g)
        hold_bwd(got, want, f"flash bwd {dtype} padded 200 -> 256")
        n += 1
    new = {r: c - routes[r] for r, c in fa.BWD_ROUTE_LAUNCHES.items()}
    if device.type == "cuda":              # a CPU rehearsal launches nothing
        require(new == {"wgmma": n // 2, "cuda_cores": n // 2},
                f"flash bwd routes {new}: want each dtype's {n // 2} cases "
                "on its route")
    log(f"  sweep: {n} cases within tolerance (routes {new}; bf16 relative "
        f"norm errors {min(rels[len(rels) // 2:]):.3e} to "
        f"{max(rels[len(rels) // 2:]):.3e}, limit {FLASH_BWD_BF16_REL_NORM})")
    errs = {}
    for name, shape, window in shapes:
        case = bwd_case(shape, torch.bfloat16, gen, device, True, window)
        got = fa.flash_attention_bwd(*case, causal=True, window=window)
        again = fa.flash_attention_bwd(*case, causal=True, window=window)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"flash bwd at {shape}: two calls differ")
        require(device.type == "cpu" or all(
            x.transpose(1, 2).is_contiguous() for x in got),
            "flash bwd gradients not in (b, s, h, d) memory")
        errs[name] = hold_bwd(got, fa.plain_flash_attention_bwd(
            *case, causal=True, window=window), f"flash bwd {name} {shape}")
        log(f"  {name} {shape} bf16 window {window}: max abs err "
            f"{errs[name][0]:.3e}, relative norm err {errs[name][1]:.3e}; two "
            "calls bit-equal")
        del case, got, again
        torch.cuda.empty_cache()
    return errs


def check_and_time_adamw(device, cfg, gen):
    """Phase 39: AdamW's kernels at ``cfg``'s tree, bf16 parameters and
    gradients, f32 moments, the clip's scale 0.5 on the device. Each
    leaf's update against the plain version (bit-equal: new parameters,
    m and v) and its sum of squares (within 1e-6 relative), then
    the whole tree's pass of each timed as in phase 6 (20 passes back to
    back for the kernels, 2 for the plain versions) beside the byte bound
    and the library's multi-tensor kernels (``torch._fused_adamw_``, which
    takes one dtype for p, g, m and v, so f32 for all four: 28 bytes a
    parameter; ``torch._foreach_norm`` on the same bf16 gradients), none of
    them on the port's path; then one AdamW.update over the tree, one call
    of each kernel a leaf. Returns the kernels' rows."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.kernels import adamw as adamw_k
    from repro_torch.models import registry
    from repro_torch.optim import AdamW
    shapes = [x.shape for x in T.leaves(registry.init(0, cfg, "meta"))]
    n = sum(math.prod(s) for s in shapes)
    ps = [torch.randn(s, generator=gen, device=device).bfloat16()
          for s in shapes]
    gs = [(torch.randn(s, generator=gen, device=device) * 1e-4).bfloat16()
          for s in shapes]
    ms = [torch.randn(s, generator=gen, device=device) * 1e-5
          for s in shapes]
    vs = [torch.rand(s, generator=gen, device=device) * 1e-9
          for s in shapes]
    scale = torch.tensor(0.5, device=device)
    hp = dict(lr=3e-4, b1=0.9, b2=0.999, bc1=1 - 0.9 ** 3,
              bc2=1 - 0.999 ** 3, eps=1e-8, weight_decay=0.01)
    sq_err = 0.0
    for p, g, m, v in zip(ps, gs, ms, vs):
        m2, v2 = m.clone(), v.clone()
        got = adamw_k.adamw_update(p, g, m2, v2, scale, **hp)
        m3, v3 = m.clone(), v.clone()
        want = adamw_k.plain_adamw_update(p, g, m3, v3, scale, **hp)
        require(torch.equal(got, want) and torch.equal(m2, m3)
                and torch.equal(v2, v3), f"the update at {tuple(p.shape)} "
                "is not bit-equal to plain_adamw_update")
        sq, sq_plain = adamw_k.sum_squares(g), adamw_k.plain_sum_squares(g)
        require(torch.equal(sq, adamw_k.sum_squares(g)),
                "two sums of squares differ")
        sq_err = max(sq_err, abs(float(sq) - float(sq_plain))
                     / float(sq_plain))
        del got, want, m2, v2, m3, v3
    log(f"  against plain: the update bit-equal (new parameters, m, v), "
        f"sums of squares rel. {sq_err:.3e}")
    require(sq_err <= 1e-6, f"sums of squares rel. {sq_err:.3e} > 1e-6")

    def update():
        for p, g, m, v in zip(ps, gs, ms, vs):
            adamw_k.adamw_update(p, g, m, v, scale, **hp)

    def plain_update():
        for p, g, m, v in zip(ps, gs, ms, vs):
            adamw_k.plain_adamw_update(p, g, m, v, scale, **hp)

    def sumsq():
        for g in gs:
            adamw_k.sum_squares(g)

    def plain_sumsq():
        for g in gs:
            adamw_k.plain_sum_squares(g)
    ps32, gs32 = [p.float() for p in ps], [g.float() for g in gs]
    counts = [torch.tensor(3.0, device=device) for _ in ps]

    def library_update():
        torch._fused_adamw_(ps32, gs32, ms, vs, [], counts, lr=hp["lr"],
                            beta1=hp["b1"], beta2=hp["b2"],
                            weight_decay=hp["weight_decay"], eps=hp["eps"],
                            amsgrad=False, maximize=False)

    def library_sumsq():
        torch._foreach_norm(gs)
    rows = {}
    for name, fn, plain, lib, per_param, lib_per_param in (
            ("adamw_update", update, plain_update, library_update,
             2 * 2 + 2 + 16, 4 * 4 + 4 * 3),
            ("sum_squares", sumsq, plain_sumsq, library_sumsq, 2, 2)):
        nbytes, lib_bytes = per_param * n, lib_per_param * n
        rows[name] = dict(
            shape=f"{len(shapes)} leaves, {n} parameters, bf16 p and g",
            ms=time_ms(fn), call_ms=call_ms(fn),
            plain_ms=time_ms(plain, runs=2, batches=3),
            library_ms=time_ms(lib),
            library_bound_ms=lib_bytes / HBM_BYTES_PER_S * 1e3,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        r = rows[name]
        log(f"  {name} over the tree: {r['ms']:.4f} ms ({nbytes} bytes, "
            f"{nbytes / r['ms'] / 1e6:.1f} GB/s, {r['bound_ms'] / r['ms']:.3f}"
            f" of its bound {r['bound_ms']:.4f} ms); alone {r['call_ms']:.4f}"
            f" ms; plain {r['plain_ms']:.4f} ms; the library's "
            f"{r['library_ms']:.4f} ms ({lib_bytes} bytes, "
            f"{lib_bytes / r['library_ms'] / 1e6:.1f} GB/s, "
            f"{r['library_bound_ms'] / r['library_ms']:.3f} of its bound "
            f"{r['library_bound_ms']:.4f} ms)")
    del ps32, gs32
    both = rows["adamw_update"]["ms"] + rows["sum_squares"]["ms"]
    bound = rows["adamw_update"]["bound_ms"] + rows["sum_squares"]["bound_ms"]
    log(f"  both: {both:.4f} ms a step against {bound:.4f} ms at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s, {bound / both:.3f} of the bound")

    params = dict(enumerate(ps))
    opt = AdamW(lr=3e-4)
    zero_counts()
    opt.update(dict(enumerate(gs)), opt.init(params), params)
    torch.cuda.synchronize()
    launches, want = kernel_counts(), want_launches(adamw=len(ps))
    log(f"  AdamW.update over the tree: launches {launches}")
    require(device.type == "cpu" or launches == want,
            f"AdamW.update over the tree launched "
            f"{launches}, want {want}")
    rows["adamw_update"].update(max_abs_err=0.0)
    rows["sum_squares"].update(max_rel_err=sq_err)
    del ps, gs, ms, vs, params
    torch.cuda.empty_cache()
    return rows


def time_flash_bwd(device, shape, gen, window: int = 0):
    """The bf16 backward on the model's views, causal with ``window``,
    against its plain version and the library's flash backward
    (``aten._scaled_dot_product_flash_attention_backward`` fed by its own
    forward, where the window does not bite), with its bound: five
    products over the visible pairs at the bf16 rate, or q, k, v, out, dO
    and lse read and dq, dk, dv written once at the memory rate."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, h, s, d = shape
    case = bwd_case(shape, torch.bfloat16, gen, device, True, window)
    q, k, v, _, lse, g = case
    w = window if 0 < window < s else s
    pairs = w * (w + 1) / 2 + (s - w) * w
    flops = 10.0 * b * h * d * pairs
    io = 8 * q.numel() * q.element_size() + lse.numel() * 4
    f = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(*case, window=window)),
        call_ms=call_ms(lambda: fa.flash_attention_bwd(*case,
                                                       window=window)),
        plain_ms=time_ms(lambda: fa.plain_flash_attention_bwd(
            *case, window=window), runs=2, batches=3),
        library_ms=None,
        bound_ms=max(flops / BF16_FLOPS_PER_S, io / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOPS_PER_S
        >= io / HBM_BYTES_PER_S else "bytes")
    if w == s:
        sdpa = torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, True)
        out, lse_s, cq, ck, mq, mk, seed, offset = sdpa[:8]
        f["library_ms"] = time_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                g, q, k, v, out, lse_s, cq, ck, mq, mk, 0.0, True, seed,
                offset))
    lib = (f" {f['ms'] / f['library_ms']:.2f}x the library's;"
           if f["library_ms"] else "")
    log(f"  flash_attention_bwd ({fa.flash_route(q.dtype, d)}) at {shape} "
        f"bf16 causal{f' window {window}' if window else ''}: "
        f"{flops / f['ms'] / 1e9:.1f} TFLOP/s of the five products, "
        f"{f['bound_ms'] / f['ms']:.3f} of its bound,{lib} "
        f"{f['call_ms']:.4f} ms a call timed alone")
    return f


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--tp-rank"]:       # one rank of phases 32-34
        task, rank, world, workdir = sys.argv[2:6]
        return tp_rank_main(task, int(rank), int(world), workdir)
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
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
    # registers and spills of every entry, and ptxas's performance
    # advisories (C75xx: a wgmma serialized for want of registers)
    log("\n".join(line for line in info["log"].splitlines()
                  if any(w in line for w in ("Compiling entry", "registers",
                                             "spill", "==", "(C75"))))

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
    # a forward for each worker's gradient and one for the loss read,
    # a backward for each gradient
    want = dict(want_launches(
        flash=cfg.n_layers * N_WORKERS * STEPS + cfg.n_layers * STEPS,
        flash_bwd=cfg.n_layers * N_WORKERS * STEPS,
        adamw=STEPS * n_leaves(cfg)), aggregate_shards=N_WORKERS * STEPS)
    log(f"  launches {launches}, expected {want}")
    require(launches == want, f"launch counts {launches} != {want}")
    routes = flash_routes()
    log(f"  flash launches by route {routes}")
    require_wgmma(routes, want, "the bf16 main path")
    torch.cuda.empty_cache()

    log("[6] timing (CUDA events, 20 calls back to back, median of 5; "
        "call_ms: each call alone, median of 20)")
    times = time_kernels(device, flat_len, main_shape, gen)
    for name, t in times.items():
        log(f"  {name}: {t}")

    ssm = ARCHS["mamba2-2.7b"]
    ssd_shape = (GLOBAL_BATCH, SEQ, ssm.ssm_nheads, ssm.ssm_headdim,
                 ssm.ssm_state, min(ssm.ssm_chunk, SEQ))
    log("[7] SSD scan and aggregate_and_apply vs plain versions")
    ssd_err = check_ssd(device, ssd_shape, gen)
    apply_err = check_agg_apply(device, flat_len, gen)
    torch.cuda.empty_cache()

    log("[8] SSM wiring at full width, depth 2, f32 and bf16")
    check_ssm_wiring(ssm.replace(n_layers=2, dtype=torch.float32), device,
                     GLOBAL_BATCH, SEQ)
    torch.cuda.empty_cache()
    check_ssm_wiring_bf16(ssm.replace(n_layers=2), device, GLOBAL_BATCH, SEQ)
    torch.cuda.empty_cache()

    scfg = ssm.replace(use_ssd_kernel=True)
    log(f"[9] slice 2: {scfg.arch_id} {scfg.n_layers} layers d_model "
        f"{scfg.d_model}, {scfg.ssm_nheads} heads of {scfg.ssm_headdim}, "
        f"state {scfg.ssm_state}, chunk {scfg.ssm_chunk}, bf16, random "
        "weights from seed 0; nothing cut (prefill runs the SSD kernel from "
        "the zero state, decode the recurrence)")
    mamba = run_family(scfg, device, 2_702_296_576, GLOBAL_BATCH, SEQ,
                       hold_serve=True)
    score_launches = mamba["score_launches"]
    serve_launches = mamba["serve_launches"]

    log("[10] timing of the slice's kernels (as in phase 6)")
    times.update(time_slice_kernels(device, flat_len, ssd_shape, gen))
    for name in ("ssd_scan", "aggregate_and_apply"):
        log(f"  {name}: {times[name]}")
    log(f"  ssd_scan, PR 12's CUDA-core kernel in the same process: "
        f"{times.pop('ssd_scan_cuda_cores_ms'):.4f} ms back to back")

    hyb, moe_arch = ARCHS["zamba2-7b"], ARCHS["qwen2-moe-a2.7b"]
    hyb_ssd_shape = (HYBRID_BATCH, HYBRID_SEQ, hyb.ssm_nheads,
                     hyb.ssm_headdim, hyb.ssm_state,
                     min(hyb.ssm_chunk, HYBRID_SEQ))
    flash_shapes = [
        (hyb.arch_id, (HYBRID_BATCH, hyb.n_heads, HYBRID_SEQ,
                       hyb.resolved_head_dim), hyb.sliding_window),
        (moe_arch.arch_id, (GLOBAL_BATCH, moe_arch.n_heads, SEQ,
                            moe_arch.resolved_head_dim), 0)]
    log("[11] the fifth slice's kernel shapes vs plain versions")
    flash112_err = check_flash_head_dim(device, gen,
                                        d=hyb.resolved_head_dim)
    flash_shape_errs = check_flash_shapes(device, flash_shapes, gen)
    torch.cuda.empty_cache()
    hyb_ssd_err = check_ssd_shape(device, hyb_ssd_shape, gen, hyb.arch_id)
    torch.cuda.empty_cache()

    log("[12] hybrid and MoE wiring at full width, reduced depth")
    depth = hyb.attn_every + 1           # one shared-block site, one tail
    check_family_wiring(hyb.replace(n_layers=depth, dtype=torch.float32),
                        device, HYBRID_BATCH, HYBRID_SEQ, ("flash", "ssd"),
                        1e-4)
    torch.cuda.empty_cache()
    check_family_wiring(hyb.replace(n_layers=depth), device, HYBRID_BATCH,
                        HYBRID_SEQ, ("flash", "ssd"), SSM_BF16_LOSS_RTOL,
                        flash_logits=True)
    torch.cuda.empty_cache()
    check_family_wiring(moe_arch.replace(n_layers=2, dtype=torch.float32),
                        device, SERVE_REQUESTS, SEQ, ("flash",), 1e-5)
    torch.cuda.empty_cache()

    zcfg = hyb.replace(use_flash_kernel=True, use_ssd_kernel=True)
    log(f"[13] slice 5: {zcfg.arch_id} {zcfg.n_layers} layers d_model "
        f"{zcfg.d_model}, {zcfg.ssm_nheads} SSD heads of {zcfg.ssm_headdim}, "
        f"state {zcfg.ssm_state}; shared attention block after every "
        f"{zcfg.attn_every} layers ({attention_sites(zcfg)} sites), "
        f"{zcfg.n_heads} heads of {zcfg.resolved_head_dim}, window "
        f"{zcfg.sliding_window}; bf16, random weights from seed 0; nothing "
        "cut")
    zamba = run_family(zcfg, device, 6_750_539_856, HYBRID_BATCH, HYBRID_SEQ,
                       hold_serve=True)

    qcfg = moe_arch.replace(use_flash_kernel=True)
    log(f"[14] slice 5: {qcfg.arch_id} {qcfg.n_layers} layers d_model "
        f"{qcfg.d_model}, {qcfg.n_experts} routed experts top-{qcfg.top_k} "
        f"+ {qcfg.n_shared_experts} shared (d_ff {qcfg.d_ff}), capacity "
        f"factor {qcfg.moe_capacity_factor}, groups of {qcfg.moe_group}, "
        f"vocab {qcfg.vocab_size}; {registry.param_count(qcfg, True)} "
        "active params; bf16, seed 0; nothing cut")
    qwen = run_family(qcfg, device, 14_315_735_040, GLOBAL_BATCH, SEQ)

    log("[15] timing of the fifth slice's kernel shapes (as in phase 6)")
    runs = {hyb.arch_id: zamba, moe_arch.arch_id: qwen}
    flash_rows = []
    for arch, shape, window in flash_shapes:
        t = time_flash(device, shape, gen, window=window)
        flash_rows.append(dict(
            model=arch, shape=list(shape), window=window,
            launches=(runs[arch]["score_launches"]["flash_attention"]
                      + runs[arch]["serve_launches"]["flash_attention"]),
            max_abs_err=flash_shape_errs[arch], **t))
        log(f"  flash_attention at {arch}'s shape: {flash_rows[-1]}")
    t, cc_ms = time_ssd(device, hyb_ssd_shape, gen)
    ssd_rows = [dict(model=hyb.arch_id, shape=list(hyb_ssd_shape),
                     launches=zamba["score_launches"]["ssd_scan"],
                     cuda_cores_ms=cc_ms, **t)]
    log(f"  ssd_scan at {hyb.arch_id}'s shape: {ssd_rows[0]}")

    log("[16] the hier train step's wiring at full width, depth 2, f32")
    check_train_step_wiring(full.replace(n_layers=2, dtype=torch.float32),
                            device, GLOBAL_BATCH, SEQ)
    torch.cuda.empty_cache()

    log(f"[17] slice 6: {cfg.arch_id} {cfg.n_layers} layers d_model "
        f"{cfg.d_model} bf16 ({n_params} params), launch/train.py::train "
        f"with the hier step at world size 1 (NCCL), batch {GLOBAL_BATCH} x "
        f"{SEQ}, {TRAIN_STEPS} steps, AdamW (warmup_cosine), the flash "
        "kernel, remat off")
    h_losses, h_step_s, h_launches, h_routes, h_peak = run_hier_training(
        cfg, device, GLOBAL_BATCH, SEQ, TRAIN_STEPS)
    log(f"  losses {h_losses}")
    log(f"  step seconds {h_step_s}; tokens/s "
        f"{[tokens / t for t in h_step_s]}; peak memory {h_peak} bytes "
        f"({h_peak / 2**30:.2f} GiB)")
    log(f"  beside phase 5's Fig. 5 pool step at the same batch: steps "
        f"2-{TRAIN_STEPS} median {statistics.median(h_step_s[1:])!r} s "
        f"against {statistics.median(step_s)!r} s; peak {h_peak / 2**30:.2f} "
        f"GiB against {peak / 2**30:.2f} GiB")
    want = want_launches(flash=cfg.n_layers * TRAIN_STEPS,
                         flash_bwd=cfg.n_layers * TRAIN_STEPS,
                         adamw=TRAIN_STEPS * n_leaves(cfg))
    log(f"  launches {h_launches}, expected {want}; flash routes {h_routes}")
    require(h_launches == want, f"launch counts {h_launches} != {want}")
    require_wgmma(h_routes, want, "hier training")
    olmo_shape = (GLOBAL_BATCH, cfg.n_heads, SEQ, cfg.resolved_head_dim)
    require(flash_shapes[1][1] == olmo_shape, "the hier step's flash shape "
            "is not the one timed in phase 15")
    hier_row = dict(
        model=f"{cfg.arch_id} (hier train step)",
        shape=list(olmo_shape), window=0,
        launches=h_launches["flash_attention"],
        max_abs_err=flash_shape_errs[moe_arch.arch_id],
        **{k: flash_rows[1][k] for k in ("ms", "call_ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by")})
    flash_rows.append(hier_row)

    log("[18] the port's train_e2e example at its default size")
    e2e_losses, e2e_s = run_train_e2e(device)
    log(f"  loss {e2e_losses[0]!r} -> min {min(e2e_losses)!r} over "
        f"{len(e2e_losses)} steps in {e2e_s:.1f} s")
    torch.cuda.empty_cache()

    audio = ARCHS["seamless-m4t-medium"]
    vision = ARCHS["llama-3.2-vision-90b"].replace(n_layers=VISION_DEPTH)
    xattn = {audio.arch_id: (audio, GLOBAL_BATCH, 878_309_376),
             vision.arch_id: (vision, VISION_BATCH, 19_224_928_264)}
    xattn_shapes = [(c.arch_id, (b, c.n_heads, SEQ, c.resolved_head_dim), 0)
                    for c, b, _ in xattn.values()]
    log("[19] the seventh slice's flash shapes vs plain versions")
    xattn_errs = check_flash_shapes(device, xattn_shapes, gen)
    torch.cuda.empty_cache()

    log("[20] vlm and audio wiring at full width, reduced depth, f32")
    for c in (audio.replace(n_layers=2, n_encoder_layers=2),
              vision.replace(n_layers=vision.cross_attn_every)):
        c = c.replace(dtype=torch.float32)
        params, batch = check_family_wiring(c, device, SERVE_REQUESTS, SEQ,
                                            ("flash",), 1e-5)
        check_cross_decode(c, params, batch)
        del params, batch
        torch.cuda.empty_cache()

    xruns = {}
    for c, b, n in xattn.values():
        c = c.replace(use_flash_kernel=True)
        cut = "nothing cut" if c.arch_id == audio.arch_id else (
            f"depth cut from 100 to {c.n_layers} layers (the full model's "
            f"{registry.param_count(ARCHS[c.arch_id])} params need 175 GB in "
            "bf16, more than the card holds)")
        log(f"[21] slice 7: {c.arch_id} ({c.family}) {c.n_layers} decoder "
            f"layers" + (f" + {c.n_encoder_layers} encoder layers"
                         if c.n_encoder_layers else
                         f" ({c.n_layers // c.cross_attn_every} of them "
                         "cross layers)")
            + f", d_model {c.d_model}, {c.n_heads} heads of "
            f"{c.resolved_head_dim} ({c.n_kv_heads} KV), d_ff {c.d_ff}, vocab "
            f"{c.vocab_size}, {n} params; bf16, seed 0, the flash kernel; "
            f"{cut}")
        xruns[c.arch_id] = run_family(c, device, n, b, SEQ, hold_first=True)

    log("[22] timing of the seventh slice's flash shapes (as in phase 6)")
    for arch, shape, window in xattn_shapes:
        t = time_flash(device, shape, gen, window=window)
        flash_rows.append(dict(
            model=arch, shape=list(shape), window=window,
            launches=(xruns[arch]["score_launches"]["flash_attention"]
                      + xruns[arch]["serve_launches"]["flash_attention"]),
            max_abs_err=xattn_errs[arch], **t))
        log(f"  flash_attention at {arch}'s shape: {flash_rows[-1]}")

    log(f"[23] the serverless projection of phase 17's run ({cfg.arch_id}, "
        f"{n_params} params, {GLOBAL_BATCH} x {SEQ}, {TRAIN_STEPS} steps): "
        "simulated Lambda seconds and dollars, not card measurements")
    proj, proj_s = run_projection(cfg, SEQ, GLOBAL_BATCH, TRAIN_STEPS)
    for mode, r in proj.items():
        log(f"  {mode}: iters {r.iters_done}, wall_s {r.wall_s!r}, cost_usd "
            f"{r.cost_usd!r}, invocations {r.invocations}, cap restarts "
            f"{r.restarts}, simulated events {r.sim_events}; host "
            f"{proj_s[mode]!r} s in EventEngine.run, "
            f"{r.sim_events / proj_s[mode]!r} events/s ({card})")

    log("[24] the port's quickstart on the card")
    qs_res, qs_err, qs_launches, qs_s = run_quickstart(device)
    log(f"  Scenario 1: deployed "
        f"{sorted({(c.workers, c.memory_mb) for c in qs_res.config_history})}"
        f", wall_s {qs_res.wall_s!r}, cost {qs_res.total_cost!r}; kernel "
        f"max abs err {qs_err!r}; {qs_s:.1f} s")

    log("[25] the golden engine trace from the port")
    t0 = time.perf_counter()
    n_lines = check_golden_trace()
    log(f"  {n_lines} lines byte for byte, twice, in "
        f"{time.perf_counter() - t0:.3f} s")

    log("[26] the port's deadline_budget, Scenario 3 (defaults; simulated "
        "Lambda seconds and dollars, not card measurements)")
    wf_res, wf_rows, wf_text, wf_s = run_scenario3()
    for line in wf_text.strip().splitlines():
        log(f"  | {line}")
    for name, (start, finish, epochs, workers, usd, grant) in wf_rows.items():
        log(f"  {name}: {start!r} -> {finish!r} s, {epochs} epochs, "
            f"{workers} workers, ${usd!r} of ${grant!r}")
    log(f"  wall_s {wf_res.wall_s!r}, ledger_usd {wf_res.ledger_usd!r}, "
        f"{len(wf_res.trace)} trace lines; equal to the JAX package's; "
        f"host {wf_s!r} s for the example's three scenarios ({card})")

    log("[27] the golden workflow trace from the port")
    gw_res, gw_lines, gw_s = check_golden_workflow()
    for name, r in gw_res.items():
        log(f"  {name}: wall_s {r.wall_s!r}, ledger_usd {r.ledger_usd!r}, "
            f"{len(r.trace)} trace lines, winners {r.winners!r}")
    log(f"  {gw_lines} lines byte for byte, each workflow twice; host "
        f"{gw_s!r} s ({card})")

    log("[28] the port's simlint over src/repro_torch")
    n_files, scoped_lines, lint_s = check_port_simlint()
    log(f"  {n_files} files, no finding; the known-bad fixture under "
        f"repro_torch/serverless and repro_torch/workflow fires "
        f"{scoped_lines}; host {lint_s!r} s ({card})")

    log(f"[29] slice 10: phase 17's run with ZeRO-3 parameters "
        f"(make_train_step(fsdp=True)): {cfg.arch_id} bf16, "
        f"launch/train.py::train, world size 1 (NCCL), batch "
        f"{GLOBAL_BATCH} x {SEQ}, {TRAIN_STEPS} steps, remat off")
    z_losses, z_step_s, z_launches, z_routes, z_peak = run_hier_training(
        cfg, device, GLOBAL_BATCH, SEQ, TRAIN_STEPS, fsdp=True)
    log(f"  losses {z_losses}")
    log(f"  step seconds {z_step_s}; tokens/s "
        f"{[tokens / t for t in z_step_s]}; peak memory {z_peak} bytes "
        f"({z_peak / 2**30:.2f} GiB) ({card})")
    log(f"  beside phase 17 (fsdp=False): steps 2-{TRAIN_STEPS} median "
        f"{statistics.median(z_step_s[1:])!r} s against "
        f"{statistics.median(h_step_s[1:])!r} s; peak {z_peak / 2**30:.2f} "
        f"GiB against {h_peak / 2**30:.2f} GiB")
    for a, b in zip(z_losses, h_losses):
        require(abs(a - b) <= 1e-5 * abs(b),
                f"ZeRO-3 losses {z_losses} != phase 17's {h_losses} "
                "(rtol 1e-5)")
    want = want_launches(flash=cfg.n_layers * TRAIN_STEPS,
                         flash_bwd=cfg.n_layers * TRAIN_STEPS,
                         adamw=TRAIN_STEPS * n_leaves(cfg))
    log(f"  launches {z_launches}, expected {want}; flash routes {z_routes}")
    require(z_launches == want, f"launch counts {z_launches} != {want}")
    require_wgmma(z_routes, want, "ZeRO-3 training")
    flash_rows.append(dict(
        hier_row, model=f"{cfg.arch_id} (ZeRO-3 train step)",
        launches=z_launches["flash_attention"]))
    torch.cuda.empty_cache()

    log(f"[30] the dry run against the card: {cfg.arch_id} ZeRO-3 hier "
        f"step, remat, batch {GLOBAL_BATCH} x {SEQ}, one-rank mesh")
    pred, d_flops, d_peak, d_held, d_launches, d_routes, d_cmp = \
        check_dryrun(device, GLOBAL_BATCH, SEQ)
    mem = pred["memory"]
    log(f"  predicted (fake CUDA tensors, trace {pred['trace_s']} s): flops "
        f"{pred['flops']!r}, bytes_accessed {pred['bytes_accessed']!r}, "
        f"collectives {pred['collectives']}, memory {mem}")
    log(f"  measured ({card}): flops {d_flops!r}; memory held before the "
        f"step {d_held} bytes, max_memory_allocated {d_peak} bytes "
        f"({d_peak / 2**30:.2f} GiB); predicted peak / measured "
        f"{mem['peak_memory_in_bytes'] / d_peak!r}")
    require(pred["flops"] == d_flops,
            f"predicted flops {pred['flops']!r} != measured {d_flops!r}")
    require(abs(mem["peak_memory_in_bytes"] - d_peak)
            <= DRYRUN_PEAK_RTOL * d_peak,
            f"predicted peak {mem['peak_memory_in_bytes']} not within "
            f"{DRYRUN_PEAK_RTOL} of {d_peak}")
    # remat runs the forward twice, the backward once
    want = want_launches(flash=2 * cfg.n_layers, flash_bwd=cfg.n_layers,
                         adamw=n_leaves(cfg))
    log(f"  launches {d_launches}, expected {want}; flash routes {d_routes}")
    require(d_launches == want, f"launch counts {d_launches} != {want}")
    require_wgmma(d_routes, want, "the checked step")
    log(f"  against the same step with remat off, on the loader's first "
        f"batch: first moments {d_cmp['mu_rel_norm']!r} (worst leaf, "
        f"{d_cmp['mu_worst_leaf']}, relative norm; tolerance "
        f"{REMAT_MU_REL_NORM}), parameter update "
        f"{d_cmp['update_rel_norm']!r} (relative norm; tolerance "
        f"{REMAT_UPDATE_REL_NORM}), {d_cmp['params_differing']} of "
        f"{d_cmp['params']} bf16 parameters differ")
    require(d_cmp["mu_rel_norm"] <= REMAT_MU_REL_NORM,
            f"remat's first moments off by {d_cmp['mu_rel_norm']!r}")
    require(d_cmp["update_rel_norm"] <= REMAT_UPDATE_REL_NORM,
            f"remat's parameter update off by {d_cmp['update_rel_norm']!r}")
    flash_rows.append(dict(
        hier_row, model=f"{cfg.arch_id} (ZeRO-3 train step, remat)",
        launches=d_launches["flash_attention"]))
    for (arch, shape), res in run_production_traces(device).items():
        log(f"  {arch} {shape} on {res['mesh']} (per-rank prediction, not a "
            f"card measurement): flops {res['flops']!r}, bytes_accessed "
            f"{res['bytes_accessed']!r}, collective_bytes "
            f"{res['collective_bytes']!r}, collectives {res['collectives']}, "
            f"memory {res['memory']}, params {res['params']}, trace_s "
            f"{res['trace_s']}")
    p_pred, p_flops, p_ssd, p_call, p_launches, p_routes, p_held = \
        check_prefill_dryrun(device, PREFILL_BATCH, PREFILL_SEQ)
    n_ssm = ssm.n_layers
    log(f"  {ssm.arch_id} prefill step {PREFILL_BATCH} x {PREFILL_SEQ}, the "
        f"SSD kernel on, one-rank mesh: predicted flops {p_pred['flops']!r} "
        f"(trace {p_pred['trace_s']} s), measured ({card}) {p_flops!r}; "
        f"smlt::ssd_scan {p_ssd!r} ({n_ssm} x {p_call!r}); launches "
        f"{p_launches}, SSD routes {p_routes}")
    require(p_pred["flops"] == p_flops,
            f"predicted prefill flops {p_pred['flops']!r} != measured "
            f"{p_flops!r}")
    require(p_ssd == n_ssm * p_call, f"smlt::ssd_scan counted {p_ssd!r}, "
            f"want {n_ssm} x {p_call!r}")
    require(p_launches == want_launches(ssd=n_ssm)
            and p_routes == {"wgmma": n_ssm, "cuda_cores": 0},
            f"prefill launches {p_launches}, routes {p_routes}: want "
            f"{n_ssm} SSD launches, all on wgmma")
    log(f"  the same step with its {len(p_held)} kernel calls held against "
        f"plain_ssd_scan: relative norm errs of y "
        f"{[float(f'{r:.3e}') for _, r in p_held]} (limit "
        f"{SSD_BF16_REL_NORM})")
    require([n for n, _ in p_held] == ["ssd_scan"] * n_ssm,
            f"prefill calls held {[n for n, _ in p_held]}, want {n_ssm} "
            "ssd_scan")
    pt = time_prefill_paths(device, PREFILL_BATCH, PREFILL_SEQ)
    log(f"  {ssm.arch_id} registry.prefill at {PREFILL_BATCH} x "
        f"{PREFILL_SEQ} ({card}): SSD kernel {pt['kernel']['seconds']} s, "
        f"{pt['kernel']['ms_per_ktok']:.2f} ms a ktok, peak "
        f"{pt['kernel']['peak'] / 2**30:.2f} GiB; ssd_chunked "
        f"{pt['chunked']['seconds']} s, {pt['chunked']['ms_per_ktok']:.2f} "
        f"ms a ktok, peak {pt['chunked']['peak'] / 2**30:.2f} GiB")

    log(f"[31] the prefill and serve steps: {cfg.arch_id} bf16, "
        f"make_prefill_step + make_serve_step (fsdp=True), one-rank mesh, "
        f"{SERVE_REQUESTS} prompts of {SEQ}, {SERVE_NEW_TOKENS} greedy "
        "tokens, against ServingEngine")
    e_stats, p_s, dec_s, p_launches = run_prefill_serve_steps(
        cfg, device, SERVE_REQUESTS, SEQ, SERVE_NEW_TOKENS)
    per_tok = 1e3 / (SERVE_NEW_TOKENS - 1) / SERVE_REQUESTS
    log(f"  tokens equal the engine's; prefill {p_s!r} s against the "
        f"engine's {e_stats['prefill_s']!r} s; decode {dec_s * per_tok!r} ms "
        f"per token per request against {e_stats['decode_s'] * per_tok!r} "
        f"({card})")
    require(p_launches == want_launches(),
            f"the steps' launches {p_launches}: prefill attends through its "
            "cache, so no kernel launches")

    p32 = run_tp_phases(device, gen, card, flash_rows, ssd_rows)
    run_tp_family_phases(device, gen, card, flash_rows, ssd_rows, p32)

    log("[38] the flash backward (csrc/flash_attention_bwd.cu) against "
        "plain_flash_attention_bwd: the sweep on both routes, the training "
        "shapes in bf16, two calls bit-equal; then timed (as in phase 6)")
    hyb_shape = (HYBRID_BATCH, hyb.n_heads, HYBRID_SEQ, hyb.resolved_head_dim)
    tp_shape = (TP_TRAIN_BATCH, cfg.n_heads // TP_RANKS, SEQ,
                cfg.resolved_head_dim)
    bwd_shapes = [
        (f"{cfg.arch_id} (Fig. 5 worker, phase 5)", main_shape, 0,
         launches["flash_attention_bwd"]),
        (f"{cfg.arch_id} (hier, ZeRO-3 and remat steps, phases 17, 29, 30)",
         olmo_shape, 0, h_launches["flash_attention_bwd"]
         + z_launches["flash_attention_bwd"]
         + d_launches["flash_attention_bwd"]),
        (f"{cfg.arch_id} (1x{TP_RANKS} rank, phases 32, 37)", tp_shape, 0,
         p32["bwd_launches"] + p32["seq_bwd_launches"]),
        (f"{hyb.arch_id} (not trained here)", hyb_shape, hyb.sliding_window,
         0)]
    t0 = time.perf_counter()
    bwd_errs = check_flash_bwd(device, gen, [x[:3] for x in bwd_shapes])
    bwd_rows = []
    for name, shape, window, n in bwd_shapes:
        t = time_flash_bwd(device, shape, gen, window=window)
        bwd_rows.append(dict(model=name, shape=list(shape), window=window,
                             launches=n, max_abs_err=bwd_errs[name][0],
                             rel_norm_err=bwd_errs[name][1], **t))
        log(f"  flash_attention_bwd at {name}: {bwd_rows[-1]}")
        torch.cuda.empty_cache()
    log(f"  phase 38 took {time.perf_counter() - t0:.1f} s ({card})")

    tied = full.replace(tie_embeddings=True)
    log(f"[39] AdamW's kernels (csrc/adamw.cu) at {tied.arch_id}'s tree "
        f"with the tied head ({registry.param_count(tied)} params) against "
        "the plain versions, then timed (as in phase 6)")
    adamw_rows = check_and_time_adamw(device, tied, gen)
    for name in ("adamw_update", "sum_squares"):
        # the calls of the training steps of phases 5, 17, 29 and 30, each
        # held above to one a leaf a step
        adamw_rows[name]["launches"] = sum(
            x[name] for x in (launches, h_launches, z_launches, d_launches))

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[40] {GRANITE_CONFIG.stem} at full width, {GRANITE_BATCH} x "
        f"{GRANITE_SEQ} tokens an evaluation: every flash, SSD and expert "
        "products call of the first held against its plain version")
    run_granite(device)
    log(f"  phase 40 took {time.perf_counter() - t0:.1f} s ({card})")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[41] mamba2-2.7b's decode step replayed as a captured CUDA graph "
        f"against the eager loop: batch {DECODE_GRAPH_BATCH}, prompts of "
        f"{', '.join(map(str, DECODE_GRAPH_LENS))}, {DECODE_GRAPH_TOKENS} "
        "greedy tokens each")
    run_decode_graph(device)
    log(f"  phase 41 took {time.perf_counter() - t0:.1f} s ({card})")

    kernels = [
        dict(name="aggregate_shards", route="cuda",
             source="src/repro_torch/kernels/csrc/hier_agg.cu",
             replaces="src/repro/kernels/hier_agg.py:24",
             launches=(launches["aggregate_shards"]
                       + qs_launches["aggregate_shards"]),
             max_abs_err=agg_err, max_abs_err_quickstart_vs_ref=qs_err,
             **times["aggregate_shards"]),
        dict(name="flash_attention", route="cuda",
             variant=fa.flash_route(torch.bfloat16, main_shape[3]),
             source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:26",
             launches=launches["flash_attention"] + sum(
                 r["launches"] for r in flash_rows),
             max_abs_err=flash_err, max_abs_err_d112=flash112_err,
             shapes=flash_rows, **times["flash_attention"]),
        dict(name="aggregate_and_apply", route="cuda",
             source="src/repro_torch/kernels/csrc/hier_agg.cu",
             replaces="src/repro/kernels/hier_agg.py:31",
             launches=(launches["aggregate_and_apply"]
                       + score_launches["aggregate_and_apply"]
                       + serve_launches["aggregate_and_apply"]),
             max_abs_err=apply_err, **times["aggregate_and_apply"]),
        dict(name="ssd_scan", route="cuda",
             variant=ssd.ssd_route(torch.bfloat16, ssd_shape[3],
                                   ssd_shape[4], ssd_shape[5]),
             source="src/repro_torch/kernels/csrc/ssd_scan_wgmma.cu",
             replaces="src/repro/kernels/ssd_scan.py:25",
             launches=score_launches["ssd_scan"] + sum(
                 r["launches"] for r in ssd_rows),
             max_abs_err=ssd_err, max_abs_err_zamba2=hyb_ssd_err,
             shapes=ssd_rows, **times["ssd_scan"]),
        dict(name="flash_attention_bwd", route="cuda",
             variant=fa.flash_route(torch.bfloat16, main_shape[3]),
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/ops.py:72",
             replaces_what="_flash_diff_bwd: the reference's backward is the "
             "vjp of its jnp blockwise attention, no Pallas kernel",
             launches=sum(r["launches"] for r in bwd_rows),
             max_abs_err=bwd_rows[0]["max_abs_err"],
             rel_norm_err=bwd_rows[0]["rel_norm_err"], shapes=bwd_rows,
             **{k: bwd_rows[0][k] for k in ("ms", "call_ms", "plain_ms",
                                            "library_ms", "bound_ms",
                                            "bound_by")}),
        *(dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/adamw.cu",
               replaces="none: src/repro/optim/adamw.py is plain jnp",
               **adamw_rows[name])
          for name in ("adamw_update", "sum_squares")),
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
