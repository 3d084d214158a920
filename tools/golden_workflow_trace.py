"""Write (or check) tests/golden_workflow_trace.txt: the workflow layer's
deterministic trace on two event-engine DAGs, from the JAX package.

    PYTHONPATH=src python tools/golden_workflow_trace.py            # rewrite
    PYTHONPATH=src python tools/golden_workflow_trace.py --check    # verify

The two workflows are those of tests/test_workflow.py:
  - ``hpo_workflow()``: an 8-trial, 2-rung (eta 2) successive-halving sweep
    of resnet18 followed by a warm-started fine-tune, under one deadline
    (3600 s) and budget ($3), at most 32 workers of up to 4096 MB, seed 0;
  - ``test_workflow_deploy_and_online_update``'s train -> eval -> deploy ->
    online_update DAG, whose deploy task runs as a ``ServingJob`` under
    bursty arrivals (deadline 4000 s, budget $50, 16 workers, seed 0).

Each workflow runs twice and must give the same trace both times. The
port must reproduce the file byte for byte: ``golden_text("repro_torch")``
(tests/test_torch_workflow.py, chip_smoke.py phase 27). The simulated
seconds and dollars are Lambda simulations, not device times.
"""
import argparse
import difflib
import importlib
import pathlib
import sys
import types

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "tests"
          / "golden_workflow_trace.txt")


def modules(pkg: str) -> types.SimpleNamespace:
    """The simulator entry points of package ``pkg`` (``repro`` or
    ``repro_torch``), imported from the modules that define them."""
    bo = importlib.import_module(f"{pkg}.core.bayes_opt")
    constraints = importlib.import_module(f"{pkg}.core.constraints")
    serverless = importlib.import_module(f"{pkg}.serverless")
    batcher = importlib.import_module(f"{pkg}.serving.batcher")
    workflow = importlib.import_module(f"{pkg}.workflow")
    return types.SimpleNamespace(
        ConfigSpace=bo.ConfigSpace, Goal=constraints.Goal,
        ServePolicy=batcher.ServePolicy, sv=serverless, wf=workflow)


def hpo_workflow(pk):
    """The sweep + fine-tune workflow; returns its ``WorkflowResult``."""
    w = pk.sv.WORKLOADS["resnet18"]
    sweep = pk.wf.HPOSweep("hpo", w, n_trials=8, rungs=2, eta=2,
                           epochs_per_rung=1, batch_size=512, samples=16384,
                           seed=3)
    specs = pk.wf.expand_hpo(sweep)
    specs.append(pk.wf.TaskSpec("finetune", w, epochs=1, batch_size=512,
                                samples=16384,
                                deps=pk.wf.sweep_final_tasks(sweep),
                                kind="finetune", warm_start_from="hpo",
                                priority=3))
    orch = pk.wf.WorkflowOrchestrator(
        pk.wf.WorkflowDAG(specs),
        pk.Goal("deadline_budget", deadline_s=3600.0, budget_usd=3.0),
        pk.sv.ServerlessPlatform(seed=0), pk.sv.ObjectStore(),
        pk.sv.ParamStore(),
        space=pk.ConfigSpace(max_workers=32, max_memory=4096),
        engine="event", sweeps=[sweep], seed=0)
    return orch.run()


def deploy_workflow(pk):
    """train -> eval -> deploy -> online_update; returns its
    ``WorkflowResult``."""
    w = pk.sv.WORKLOADS["resnet18"]
    sv = pk.sv.ServingTask(
        policy=pk.ServePolicy(8, 0.2, 2048),
        arrivals=pk.sv.ArrivalSpec(base_rps=20.0, bursts_per_hour=6.0),
        duration_s=90.0, flops_per_request=2e9, model_bytes=50e6,
        code_bytes=5e6, slo_s=1.0, cold_start_s=0.8, keep_warm_s=30.0,
        max_instances=8)
    TaskSpec = pk.wf.TaskSpec
    dag = pk.wf.WorkflowDAG([
        TaskSpec("train", w, epochs=1, batch_size=512, samples=4096),
        TaskSpec("eval", w, epochs=1, batch_size=512, samples=1024,
                 deps=("train",), kind="eval"),
        TaskSpec("deploy", w, deps=("eval",), kind="deploy", serving=sv),
        TaskSpec("update", w, epochs=1, batch_size=512, samples=2048,
                 deps=("deploy",), kind="online_update",
                 warm_start_from="train"),
    ])
    orch = pk.wf.WorkflowOrchestrator(
        dag, pk.Goal("deadline_budget", deadline_s=4000.0, budget_usd=50.0),
        pk.sv.ServerlessPlatform(seed=0), pk.sv.ObjectStore(),
        pk.sv.ParamStore(), space=pk.ConfigSpace(max_workers=16),
        engine="event", seed=0)
    return orch.run()


WORKFLOWS = {
    "hpo": ("8 trials, 2 rungs, eta 2, then a fine-tune; resnet18, event "
            "engine, deadline 3600 s, budget $3, seed 0", hpo_workflow),
    "deploy": ("train -> eval -> deploy (ServingJob) -> online_update; "
               "resnet18, event engine, deadline 4000 s, budget $50, seed 0",
               deploy_workflow),
}


def golden_text(pkg: str):
    """(the trace file's text, each workflow's ``WorkflowResult``) from
    package ``pkg``; each workflow runs twice and must agree with itself."""
    pk = modules(pkg)
    lines, results = [], {}
    for name, (what, build) in WORKFLOWS.items():
        first, second = build(pk), build(pk)
        if first.trace != second.trace:
            raise RuntimeError(f"{pkg}: the {name} workflow's trace differs "
                               "between two runs")
        lines += [f"# {name}: {what}"] + first.trace
        results[name] = first
    return "\n".join(lines) + "\n", results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="compare with the checked-in file; write nothing")
    args = ap.parse_args(argv)
    text, results = golden_text("repro")
    old = GOLDEN.read_text() if GOLDEN.exists() else ""
    n = sum(len(r.trace) for r in results.values())
    if args.check:
        if text != old:
            sys.stderr.writelines(difflib.unified_diff(
                old.splitlines(keepends=True), text.splitlines(keepends=True),
                fromfile="checked-in", tofile="regenerated"))
            print(f"FAIL: {GOLDEN} is not regenerable byte-identical",
                  file=sys.stderr)
            return 1
        print(f"OK: {GOLDEN} regenerates byte-identical ({n} trace lines)")
        return 0
    GOLDEN.write_text(text)
    print(f"wrote {GOLDEN} ({n} trace lines, "
          f"{'changed' if text != old else 'unchanged'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
