"""What the benchmark measures with: seeds, the card's published peaks, the
device-kernel families, model FLOPs from the counts a configuration file
states, the comparisons that decide ``correct`` and the rounding of the
fp8 control. Imports neither the program nor JAX.
"""
from __future__ import annotations

import re
import statistics

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# device kernels by family; the first pattern that matches names the
# family (the table of the port's profiling tool, copied)
FAMILIES = (
    ("collective", r"nccl"),
    ("flash", r"flash_fwd"),
    ("flash_bwd", r"bwd_(prep|dkdv|dq)"),
    ("ssd_scan", r"ssd_scan(_wgmma)?_kernel"),
    ("aggregation", r"agg_kernel"),
    ("matmul_bf16", r"nvjet|bf16|h_bz"),
    ("matmul_f32", r"f32f32|sgemm"),
    ("matmul_other", r"gemm|xmma|cutlass|cublas"),
    ("reduction", r"reduce|Reduce"),
    ("softmax", r"softmax|logsumexp|LogSumExp"),
    ("scan", r"scan"),
    ("copy", r"copy|Copy|cat|Cat|direct_copy"),
    ("index", r"index|Index|gather|scatter|embedding"),
    ("elementwise", r"elementwise|vectorized|Elementwise|unrolled"),
)


def family(kernel: str) -> str:
    for name, pattern in FAMILIES:
        if re.search(pattern, kernel):
            return name
    return "other"


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (weights, the
    batch of step i, ...): the same seed and keys give the same number."""
    words = [int(seed) % 2 ** 64]
    for k in keys:
        words.append(k if isinstance(k, int) else
                     int.from_bytes(str(k).encode()[:16].ljust(16, b"\0"),
                                    "little"))
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) >> 1


# ---------------------------------------------------------------------------
# model FLOPs, as a configuration file states them
# ---------------------------------------------------------------------------


def model_flops(config: dict, work: dict):
    """The model FLOPs of ``work``, {kind: {"tokens": t, "keys": k}} (a
    loop's counter): t tokens of each kind ("train", "score", "prefill",
    "decode", "head"), which together attend to k keys. Each kind's count
    is the configuration file's ``flops_per_token`` entry,
    {"per_token": a, "per_key": b}: a t + b k. None where the file gives
    no count for a kind of the work."""
    counts = config.get("flops_per_token", {})
    if not work or any(kind not in counts for kind in work):
        return None
    return sum(counts[kind]["per_token"] * n["tokens"]
               + counts[kind]["per_key"] * n["keys"]
               for kind, n in work.items())


def causal_keys(length: int) -> int:
    """The keys that the tokens of one causal sequence attend to."""
    return length * (length + 1) // 2


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The largest |prog norm - ref norm| of a leaf, over the ref norm of
    that leaf or of the median leaf, whichever is larger. ``keep`` names
    the leaves that count (all by default)."""
    names = [k for k in ref if keep is None or k in keep]
    median = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in names)


def moved_leaves(first_grad: dict) -> set:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(first_grad.values())
    return {k for k, v in first_grad.items() if v >= 1e-3 * median}


def fp8_round(x):
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448), back in x's dtype: the fp8 control's matmul
    inputs. The gradient passes the rounding unchanged (in x's dtype)."""
    import torch
    with torch.no_grad():
        scale = x.abs().amax().float().clamp(min=1e-30) / 448.0
        q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return q if not x.requires_grad else x + (q - x).detach()
