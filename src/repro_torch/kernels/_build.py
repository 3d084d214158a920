"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface; ``csrc/hopper.cuh`` holds
the Hopper pieces the tensor-core kernels share. ``load()`` compiles them
with ``nvcc`` for ``sm_90a`` (one process per source, all started
together), links them into one shared library under ``build/`` at the repo
root, and opens it with ``ctypes``. The library is named by a hash of the
sources, the headers they include and the flags, so an edit builds anew
and an unchanged source set is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("hier_agg.cu", "flash_attention.cu", "flash_attention_wgmma.cu",
           "flash_attention_bwd.cu", "ssd_scan.cu", "ssd_scan_wgmma.cu",
           "adamw.cu")
HEADERS = ("hopper.cuh",)  # included by the sources: part of the hash
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: the aggregation must divide exactly as the plain
# version does, the CUDA-core softmax and the SSD decays use the accurate
# expf, and the tensor-core softmax exp2f without flushing denormals
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library of this source set (sources, headers, flags)
    lives: an edit to any of them names another library."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in SOURCES + HEADERS:
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"libsmlt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels if this source set has no library yet;
    returns the library's path."""
    srcs = [CSRC / s for s in SOURCES]
    lib = library_path()
    if lib.exists():
        _build_info.update(path=str(lib), seconds=0.0, log="(cached)")
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{s.stem}.{os.getpid()}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {s.name}\n{out}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
    _build_info.update(path=str(lib), seconds=time.perf_counter() - t0,
                       log="\n".join(logs))
    return lib


def build_info() -> dict:
    """Path, build seconds and nvcc/ptxas output of the last ``build()``."""
    return dict(_build_info)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.smlt_aggregate_shards.argtypes = [p, p, i64, i64, i32, p]
    lib.smlt_aggregate_shards.restype = i32
    lib.smlt_aggregate_and_apply.argtypes = [p, p, p, i64, i64,
                                             ctypes.c_float, i32, p]
    lib.smlt_aggregate_and_apply.restype = i32
    lib.smlt_flash_attention_fwd.argtypes = [
        p, p, p, p, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, p, p]
    lib.smlt_flash_attention_fwd.restype = i32
    lib.smlt_flash_attention_fwd_wgmma.argtypes = [
        p, p, p, p, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, p, p]
    lib.smlt_flash_attention_fwd_wgmma.restype = i32
    for fn in (lib.smlt_flash_attention_fwd_lse,
               lib.smlt_flash_attention_fwd_wgmma_lse):
        fn.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32,
                       ctypes.c_float, p, p]
        fn.restype = i32
    for fn in (lib.smlt_flash_attention_bwd,
               lib.smlt_flash_attention_bwd_wgmma):
        fn.argtypes = [p] * 11 + [i32] * 7 + [ctypes.c_float, p, p]
        fn.restype = i32
    lib.smlt_wgmma_tile.argtypes = [i32, p, p, p, i32, p]
    lib.smlt_wgmma_tile.restype = i32
    lib.smlt_ssd_scan.argtypes = [p] * 8 + [i32] * 6 + [i64] * 4 + [i32, p]
    lib.smlt_ssd_scan.restype = i32
    lib.smlt_ssd_scan_wgmma.argtypes = [p] * 8 + [i32] * 6 + [p, p]
    lib.smlt_ssd_scan_wgmma.restype = i32
    lib.smlt_ssd_wgmma_tile.argtypes = [i32] + [p] * 6
    lib.smlt_ssd_wgmma_tile.restype = i32
    lib.smlt_adamw_update.argtypes = [p] * 6 + [i64] + [ctypes.c_float] * 9 \
        + [i32, i32, p]
    lib.smlt_adamw_update.restype = i32
    lib.smlt_sum_squares.argtypes = [p, p, i64, p, i64, i32, p]
    lib.smlt_sum_squares.restype = i32
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use. Raises if it cannot be
    built or opened; callers on a CUDA tensor never fall back."""
    global _lib
    if _lib is None:
        _lib = _declare(ctypes.CDLL(str(build())))
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
