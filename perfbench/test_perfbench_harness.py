"""The harness end to end on the CPU, at the tiny sizes: every cell runs
and comes out correct; a configuration, a mix and a metric added as new
files are found by name; each fault a cell can have, planted under the
timed path, and the fp8 control make ``correct`` false; run.py refuses
to run without a card or without the program; BENCHMARK.json keeps to
its contract."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench._testing import REPO, run, tiny_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct(root, cell, trace):
    r = run(root, cell, trace=trace)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    want = {m["name"] for m in harness.metrics_of(BENCH, cell, trace)}
    if trace:   # a CPU run has no device trace: those readers stay silent
        assert set(r["metrics"]) <= want
    else:
        assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())


def test_same_seed_same_readings(root):
    """Training is compared on its first steps, which the seed fixes."""
    a = run(root, "olmo-1b.hier-train", seed=99)
    b = run(root, "olmo-1b.hier-train", seed=99)
    assert a["checks"] == b["checks"]


def test_new_files_found_by_name(root, tmp_path):
    """A configuration, a mix, a metric and a cell added as new files and
    new BENCHMARK.json entries, with no edit to a file that is there."""
    new = tmp_path / "copy"
    shutil.copytree(root, new)
    pb = new / "perfbench"
    cfg = json.loads((pb / "configs" / "olmo-1b.json").read_text())
    cfg["name"] = "olmo-narrow"
    cfg["model"]["d_ff"] = 64
    # its model FLOPs are its own file's: the yardstick knows no family
    cfg["flops_per_token"] = {"train": {"per_token": 5e5, "per_key": 7}}
    (pb / "configs" / "olmo-narrow.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "hier-train.json").read_text())
    mix["batch"] = 4
    (pb / "traffic" / "hier-small.json").write_text(json.dumps(mix))
    # one reader that every kind of the metric shares (tokens.train, ...)
    (pb / "metrics" / "tokens.py").write_text(
        "def read(run):\n"
        "    return float(run.counters['work']['train']['tokens'])\n")
    (pb / "limits" / "olmo-narrow.hier-small.json").write_text(
        (pb / "limits" / "olmo-1b.hier-train.json").read_text())
    b = json.loads((new / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="olmo-narrow",
                             file="perfbench/configs/olmo-narrow.json"))
    b["workloads"].append({"name": "olmo-narrow.hier-small",
                           "config": "olmo-narrow", "traffic": "hier-small",
                           "chips": 1, "why": "test"})
    b["end_to_end"][0]["workloads"].append("olmo-narrow.hier-small")
    for m in b["per_layer"]:
        if m["name"] == "mfu.train":
            m["workloads"].append("olmo-narrow.hier-small")
    b["per_layer"].append({"name": "tokens.train", "unit": "tokens",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "train_tokens_per_s",
                           "workloads": ["olmo-narrow.hier-small"]})
    (new / "BENCHMARK.json").write_text(json.dumps(b))
    r = run(new, "olmo-narrow.hier-small", trace=True)
    assert r["correct"]
    assert r["metrics"]["tokens.train"]["value"] >= 1
    assert r["metrics"]["mfu.train"]["value"] > 0
    assert "train_tokens_per_s" in run(new, "olmo-narrow.hier-small")[
        "metrics"]


# ---------------------------------------------------------------------------
# faults under the timed path, and the control
# ---------------------------------------------------------------------------


def _unchanged_state(mp):
    from repro_torch.optim import adamw
    mp.setattr(adamw.AdamW, "update",
               lambda self, grads, state, params, **kw: (params, state))


def _half_batch_pool(mp):
    from repro_torch.serverless import worker
    orig = worker.LocalWorkerPool.step
    mp.setattr(worker.LocalWorkerPool, "step", lambda self, p, b: orig(
        self, p, {k: v[:v.shape[0] // 2] for k, v in b.items()}))


def _half_batch_hier(mp):
    from repro_torch.launch import steps
    orig = steps.TrainStep.__call__
    mp.setattr(steps.TrainStep, "__call__", lambda self, p, s, b: orig(
        self, p, s, {k: v[:v.shape[0] // 2] for k, v in b.items()}))


def _no_exchange(mp):
    from repro_torch.kernels import ops
    mp.setattr(ops, "aggregate_shards", lambda shards, **kw: shards[0] * 1)


def _half_batch_loss(mp):
    from repro_torch.models import registry
    orig = registry.loss_fn
    mp.setattr(registry, "loss_fn", lambda p, cfg, b: orig(
        p, cfg, {k: v[:v.shape[0] // 2] for k, v in b.items()}))


def _answer_altered(mp):
    from repro_torch.models import registry
    orig = registry.loss_fn
    mp.setattr(registry, "loss_fn", lambda p, cfg, b: orig(p, cfg, b) * 1.05)


def _token_altered(mp):
    from repro_torch.serving import engine
    orig = engine.ServingEngine.serve_batch

    def serve_batch(self, reqs):
        out = orig(self, reqs)
        for c in out:
            c.tokens[len(c.tokens) // 2] = (c.tokens[len(c.tokens) // 2]
                                            + 1) % self.cfg.vocab_size
        return out
    mp.setattr(engine.ServingEngine, "serve_batch", serve_batch)


FAULTS = [("olmo-1b.pool-train", _unchanged_state),
          ("olmo-1b.pool-train", _half_batch_pool),
          ("olmo-1b.pool-train", _no_exchange),
          ("olmo-1b.hier-train", _unchanged_state),
          ("olmo-1b.hier-train", _half_batch_hier),
          ("mamba2-2.7b.score", _half_batch_loss),
          ("mamba2-2.7b.score", _answer_altered),
          ("mamba2-2.7b.serve", _token_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run(root, cell)
    assert not r["correct"], r["checks"]


# at this size fp8 matmuls move a served token's logit by less than the
# full-size limit; there the control reads 2.1-2.9 against 0.8 (PERF.md)
SEPARATED_ONLY = {"mamba2-2.7b.serve"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    """The reference with fp8 matmuls, in the program's place, reads at
    least three times what the program reads on one number, and fails the
    cell's limits."""
    ctl = run(root, cell, variant="fp8")["checks"]
    prog = run(root, cell)["checks"]
    assert any(ctl[k]["value"] > 0 and ctl[k]["value"] >= 3 * prog[k][
        "value"] for k in ctl), (ctl, prog)
    if cell not in SEPARATED_ONLY:
        assert not all(c["value"] <= c["limit"] for c in ctl.values()), ctl


# ---------------------------------------------------------------------------
# run.py's refusals, and the contract of BENCHMARK.json
# ---------------------------------------------------------------------------


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(cwd)})


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run_py(REPO)
    assert out.returncode != 0 and out.stdout == ""


def test_run_py_refuses_without_the_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(b["workloads"]) * 14 + 2 <= 24 * 14 + 2
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and harness.metric_file(
            REPO, m["name"]).is_file()
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    pairs = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert len(w["why"]) <= 200
        reported = harness.metrics_of(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2 and harness.metrics_of(b, w["name"], True)
        assert (REPO / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith(
            "perfbench/")
    assert len(json.dumps(b)) < 64 * 1024
