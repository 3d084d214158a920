"""For the CPU tests: a copy of the benchmark's files whose configurations
and mixes are cut to a size a test run holds (float32, two layers, width
64, sequences of 32), run through the harness on the CPU."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

TINY_MODEL = {"dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                            d_ff=128, vocab_size=250, dtype="float32"),
              # wide enough that logits spread as at full size (std
              # 0.02 sqrt(d)): an altered served token then lies well below
              # the best, as it does there
              "ssm": dict(n_layers=2, d_model=1024, ssm_state=16,
                          ssm_headdim=64, ssm_chunk=16, vocab_size=2045,
                          dtype="float32")}
TINY_TRAFFIC = {"pool_train": dict(seq=32), "hier_train": dict(seq=32),
                "score": dict(seq=32, batch=4),
                "serve": dict(prompt_lens=[8, 16, 24, 32], new_tokens=6,
                              batch=2, checked=3)}


def tiny_root(dst: Path) -> Path:
    """``dst`` holding BENCHMARK.json and perfbench/ with every
    configuration and mix cut to the tiny sizes."""
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        f = dst / c["file"]
        cfg = json.loads(f.read_text())
        cfg["model"].update(TINY_MODEL[cfg["model"]["family"]])
        f.write_text(json.dumps(cfg))
    for f in (dst / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(TINY_TRAFFIC[t["loop"]])
        f.write_text(json.dumps(t))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def run(root: Path, cell: str, seed: int = 2 ** 31 + 12345,
        seconds: float = 0.2, trace: bool = False, variant=None) -> dict:
    import torch
    from perfbench import harness
    return harness.run_cell(root, cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            variant=variant)
