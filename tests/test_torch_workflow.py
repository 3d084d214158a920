"""Parity of the port's workflow layer (task DAG, budget allocator,
successive-halving tuner, orchestrator) with the JAX package's: each
scenario of tests/test_workflow.py runs through both packages, the results
are held equal with ``==`` (no tolerance: these are deterministic numpy
layers) and the reference test's own assertions are applied to each
package's result; both packages reproduce tests/golden_workflow_trace.txt
byte for byte."""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_sim_parity import PORT, REF, same  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def W(pk):
    return pk.worker.WORKLOADS["resnet18"]


def raised(fn, match):
    """``fn()`` raises ValueError matching ``match``; returns its message."""
    with pytest.raises(ValueError, match=match) as e:
        fn()
    return str(e.value)


def chain_dag(pk, epochs=(2, 1, 1), samples=(4096, 2048, 1024)):
    T, w = pk.dag.TaskSpec, W(pk)
    return pk.dag.WorkflowDAG([
        T("train", w, epochs=epochs[0], batch_size=512, samples=samples[0]),
        T("finetune", w, epochs=epochs[1], batch_size=512,
          samples=samples[1], deps=("train",), kind="finetune",
          warm_start_from="train"),
        T("eval", w, epochs=epochs[2], batch_size=512, samples=samples[2],
          deps=("finetune",), kind="eval"),
    ])


def goal(pk, budget=10.0, deadline=3600.0):
    return pk.constraints.Goal("deadline_budget", deadline_s=deadline,
                               budget_usd=budget)


def orchestrate(pk, dag, g, *, engine="analytic", sweeps=(), seed=0,
                max_workers=32, max_memory=4096):
    orch = pk.orchestrator.WorkflowOrchestrator(
        dag, g, pk.platform.ServerlessPlatform(seed=seed),
        pk.stores.ObjectStore(), pk.stores.ParamStore(),
        space=pk.bayes_opt.ConfigSpace(max_workers=max_workers,
                                       max_memory=max_memory),
        engine=engine, sweeps=sweeps, seed=seed)
    return orch, orch.run()


def allocator(pk, specs, budget):
    return pk.allocator.BudgetAllocator(
        pk.dag.WorkflowDAG(specs), goal(pk, budget), pk.stores.ParamStore(),
        pk.stores.ObjectStore(),
        space=pk.bayes_opt.ConfigSpace(max_workers=32))


def hpo_workflow(pk, budget=3.0):
    sweep = pk.tuner.HPOSweep("hpo", W(pk), n_trials=8, rungs=2, eta=2,
                              epochs_per_rung=1, batch_size=512,
                              samples=16384, seed=3)
    specs = pk.tuner.expand_hpo(sweep)
    specs.append(pk.dag.TaskSpec(
        "finetune", W(pk), epochs=1, batch_size=512, samples=16384,
        deps=pk.tuner.sweep_final_tasks(sweep), kind="finetune",
        warm_start_from="hpo", priority=3))
    return pk.dag.WorkflowDAG(specs), goal(pk, budget), sweep


def serving_task(pk, **kw):
    return pk.arrivals.ServingTask(
        policy=pk.batcher.ServePolicy(8, 0.2, 2048), flops_per_request=2e9,
        **kw)


# -- the 16 scenarios of tests/test_workflow.py, each a function of one
# package; each returns what both packages must agree on ---------------------

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def dag_validation(pk):
    T, D, w = pk.dag.TaskSpec, pk.dag.WorkflowDAG, W(pk)
    return [
        raised(lambda: D([T("a", w), T("a", w)]), "duplicate"),
        raised(lambda: D([T("a", w, deps=("ghost",))]), "unknown dependency"),
        raised(lambda: T("a", w, deps=("a",)), "itself"),
        raised(lambda: D([T("a", w, deps=("b",)), T("b", w, deps=("a",))]),
               "cycle"),
        raised(lambda: T("a", w, kind="banana"), "kind"),
    ]


@scenario
def dag_order_ready_descendants(pk):
    T, w = pk.dag.TaskSpec, W(pk)
    dag = pk.dag.WorkflowDAG([T("c", w, deps=("a", "b")), T("a", w),
                              T("b", w, deps=("a",)), T("d", w, deps=("c",))])
    ready = [[t.name for t in dag.ready(done=d)]
             for d in (set(), {"a"}, {"a", "b"})]
    desc = dag.descendants("a"), dag.descendants("d")
    assert dag.order == ["a", "b", "c", "d"]
    assert ready == [["a"], ["b"], ["c"]]
    assert desc == ({"b", "c", "d"}, set())
    return dag.order, ready, sorted(desc[0]), sorted(desc[1])


@scenario
def dag_tails_and_critical_path(pk):
    T, w = pk.dag.TaskSpec, W(pk)
    dag = pk.dag.WorkflowDAG([T("root", w), T("long", w, deps=("root",)),
                              T("short", w, deps=("root",)),
                              T("sink", w, deps=("long", "short"))])
    walls = {"root": 10.0, "long": 100.0, "short": 5.0, "sink": 20.0}
    tails = dag.tails(walls)
    length, path = dag.critical_path(walls)
    assert tails["sink"] == 0.0 and tails["long"] == 20.0
    assert tails["root"] == pytest.approx(120.0)
    assert length == pytest.approx(130.0) and path == ["root", "long", "sink"]
    return tails, length, path


@scenario
def allocator_grants_priorities_and_windows(pk):
    T, w = pk.dag.TaskSpec, W(pk)
    alloc = allocator(pk, [
        T("hi", w, epochs=1, batch_size=512, samples=8192, priority=4),
        T("lo", w, epochs=1, batch_size=512, samples=8192, priority=1),
    ], budget=4.0)
    grants, drops = alloc.allocate(now_s=0.0, spent_usd=0.0, running={},
                                   finished=set(), dropped=set(),
                                   ready=["hi", "lo"])
    assert not drops
    assert grants["hi"].budget_usd > grants["lo"].budget_usd
    total = sum(g.budget_usd for g in grants.values())
    assert total <= alloc.goal.budget_usd * alloc.safety + 1e-9
    assert all(g.deadline_s <= alloc.goal.deadline_s for g in grants.values())
    lo_w = alloc.workers_for_budget("hi", grants["lo"].budget_usd)
    hi_w = alloc.workers_for_budget("hi", grants["hi"].budget_usd)
    assert hi_w[1] >= lo_w[1] and hi_w[0] >= lo_w[0] >= 1
    return grants, sorted(drops), lo_w, hi_w, alloc.forecasts


@scenario
def allocator_reallocates_unspent_budget(pk):
    T, w = pk.dag.TaskSpec, W(pk)
    alloc = allocator(pk, [
        T("first", w, epochs=1, batch_size=512, samples=8192),
        T("second", w, epochs=1, batch_size=512, samples=8192,
          deps=("first",)),
    ], budget=2.0)
    g0, _ = alloc.allocate(now_s=0.0, spent_usd=0.0, running={},
                           finished=set(), dropped=set(), ready=["first"])
    out = [g0]
    for spent in (0.1 * g0["first"].budget_usd, g0["first"].budget_usd):
        out.append(alloc.allocate(now_s=100.0, spent_usd=spent, running={},
                                  finished={"first"}, dropped=set(),
                                  ready=["second"])[0])
    assert out[1]["second"].budget_usd > out[2]["second"].budget_usd
    return out


@scenario
def allocator_drops_by_priority_under_deadline_pressure(pk):
    T, w = pk.dag.TaskSpec, W(pk)
    alloc = allocator(pk, [
        T("must", w, epochs=1, batch_size=512, samples=8192, priority=5),
        T("nice", w, epochs=1, batch_size=512, samples=8192, priority=1,
          droppable=True, deps=("must",)),
        T("nice-child", w, epochs=1, batch_size=512, samples=8192,
          deps=("nice",), droppable=True, priority=3),
    ], budget=4.0)
    chain = alloc.forecasts["must"].wall_s + alloc.forecasts["nice"].wall_s
    grants, drops = alloc.allocate(
        now_s=alloc.goal.deadline_s - chain * 1.01, spent_usd=0.0,
        running={}, finished=set(), dropped=set(), ready=["must"])
    assert "nice" in drops and "nice-child" in drops and "must" in grants
    return grants, list(drops)


@scenario
def expand_hpo_shape_and_deps(pk):
    sweep = pk.tuner.HPOSweep("hpo", W(pk), n_trials=8, rungs=2, eta=2,
                              seed=1)
    specs = pk.tuner.expand_hpo(sweep)
    names = [s.name for s in specs]
    r0 = tuple(n for n in names if ":r0:" in n)
    assert len(r0) == 8 and len([n for n in names if ":r1:" in n]) == 4
    assert all(s.deps == (r0 if s.rung == 1 else ()) for s in specs)
    final = pk.tuner.sweep_final_tasks(sweep)
    assert final == tuple(n for n in names if ":r1:" in n)
    err = raised(lambda: pk.tuner.HPOSweep("bad", W(pk), n_trials=2,
                                           rungs=3, eta=2), "empty final")
    return specs, final, err


@scenario
def successive_halving_selection_and_warm_start(pk):
    sweep = pk.tuner.HPOSweep("hpo", W(pk), n_trials=4, rungs=2, eta=2,
                              seed=7)
    tuner = pk.tuner.SuccessiveHalving(sweep)
    specs = {s.name: s for s in pk.tuner.expand_hpo(sweep)}
    cfgs = {}
    for i in range(4):
        spec = specs[f"hpo:r0:t{i}"]
        assert tuner.assign(spec) == i
        cfgs[i] = pk.bayes_opt.Config(workers=4 + i, memory_mb=1024)
        tuner.report(spec, epochs_done=1, config=cfgs[i])
    ranked = tuner.survivors_of(0)
    assert len(ranked) == 4
    assert tuner.scores[ranked[0]] <= tuner.scores[ranked[-1]]
    s0 = specs["hpo:r1:s0"]
    slot = tuner.assign(s0)
    warm = tuner.warm_config(s0)
    assert slot == ranked[0] and warm == cfgs[ranked[0]]
    losses = [(tuner.loss(t, 1), tuner.loss(t, 2)) for t in range(4)]
    assert all(two < one for one, two in losses)
    best, loss = tuner.best()
    assert best == ranked[0] and loss == tuner.scores[best]
    return ranked, tuner.scores, slot, warm, losses, (best, loss)


@scenario
def workflow_analytic_chain(pk):
    g = goal(pk)
    orch, res = orchestrate(pk, chain_dag(pk), g, engine="analytic")
    assert set(res.tasks) == {"train", "finetune", "eval"} and not res.dropped
    assert res.finish_s["train"] <= res.start_s["finetune"]
    assert res.finish_s["finetune"] <= res.start_s["eval"]
    assert res.wall_s == pytest.approx(res.finish_s["eval"])
    assert res.wall_s <= g.deadline_s and res.ledger_usd <= g.budget_usd
    assert res.cost_usd == pytest.approx(res.ledger_usd, rel=1e-6)
    job_usd = orch.platform.ledger.job_usd
    assert set(job_usd) == {"train", "finetune", "eval"}
    assert sum(job_usd.values()) == pytest.approx(res.cost_usd, rel=1e-6)
    return res, job_usd


@scenario
def workflow_event_tasks_overlap_on_shared_domain(pk):
    T, w = pk.dag.TaskSpec, W(pk)
    dag = pk.dag.WorkflowDAG([
        T("a", w, epochs=1, batch_size=512, samples=4096),
        T("b", w, epochs=1, batch_size=512, samples=4096),
        T("join", w, epochs=1, batch_size=512, samples=2048,
          deps=("a", "b"), kind="eval"),
    ])
    orch, res = orchestrate(pk, dag, goal(pk), engine="event",
                            max_workers=16)
    assert res.wall_s < sum(r.wall_s for r in res.tasks.values())
    assert res.start_s["a"] == res.start_s["b"] == 0.0
    assert res.start_s["join"] == pytest.approx(
        max(res.finish_s["a"], res.finish_s["b"]))
    alive, union = orch.param_store.alive_seconds, orch.domain.sync_union_s
    assert alive == pytest.approx(union, rel=1e-9)
    return res, alive, union


@scenario
def workflow_seed_determinism(pk):
    traces = [orchestrate(pk, chain_dag(pk, epochs=(1, 1, 1)), goal(pk),
                          engine="event", max_workers=16)[1].trace
              for _ in range(2)]
    assert traces[0] == traces[1]
    return traces


@scenario
def workflow_hpo_end_to_end(pk):
    dag, g, sweep = hpo_workflow(pk)
    orch, res = orchestrate(pk, dag, g, engine="event", sweeps=[sweep])
    assert all(res.tasks[n].epochs_done >= 1 for n in dag.order)
    assert not res.dropped
    assert res.ledger_usd <= g.budget_usd and res.wall_s <= g.deadline_s
    winner, _ = res.winners["hpo"]
    r0 = f"hpo:r0:t{winner}"
    r1 = next(n for n, t in res.assignments.items()
              if t == winner and ":r1:" in n)
    assert res.allocations[r1].budget_usd > res.allocations[r0].budget_usd
    assert res.config_of(r1).workers > res.config_of(r0).workers
    assert winner in orch.tuners["hpo"].configs
    final = pk.tuner.sweep_final_tasks(sweep)
    assert res.start_s["finetune"] == pytest.approx(
        max(res.finish_s[n] for n in final))
    return res, orch.tuners["hpo"].configs, orch.tuners["hpo"].scores


@scenario
def workflow_hpo_bit_identical_trace(pk):
    runs = []
    for _ in range(2):
        dag, g, sweep = hpo_workflow(pk)
        runs.append(orchestrate(pk, dag, g, engine="event",
                                sweeps=[sweep])[1])
    a, b = runs
    assert a.trace == b.trace
    assert a.wall_s == b.wall_s and a.cost_usd == b.cost_usd
    return a.trace, a.wall_s, a.cost_usd


@scenario
def workflow_tight_budget_truncates_not_overspends(pk):
    dag, g, sweep = hpo_workflow(pk, budget=1.2)
    _, res = orchestrate(pk, dag, g, engine="event", sweeps=[sweep])
    assert res.ledger_usd <= g.budget_usd
    assert set(res.tasks) | set(res.dropped) == set(dag.order)
    return res


@scenario
def deploy_task_validation(pk):
    T, w = pk.dag.TaskSpec, W(pk)
    sv = serving_task(pk, arrivals=pk.arrivals.ArrivalSpec(base_rps=5.0),
                      duration_s=60.0)
    spec = T("d", w, kind="deploy", serving=sv)
    return [raised(lambda: T("d", w, kind="deploy"), "needs a ServingTask"),
            raised(lambda: T("t", w, kind="train", serving=sv),
                   "only valid on"),
            raised(spec.plans, "ServingJob"), spec]


@scenario
def workflow_deploy_and_online_update(pk):
    T, w = pk.dag.TaskSpec, W(pk)
    sv = serving_task(
        pk, arrivals=pk.arrivals.ArrivalSpec(base_rps=20.0,
                                             bursts_per_hour=6.0),
        duration_s=90.0, model_bytes=50e6, code_bytes=5e6, slo_s=1.0,
        cold_start_s=0.8, keep_warm_s=30.0, max_instances=8)
    dag = pk.dag.WorkflowDAG([
        T("train", w, epochs=1, batch_size=512, samples=4096),
        T("eval", w, epochs=1, batch_size=512, samples=1024,
          deps=("train",), kind="eval"),
        T("deploy", w, deps=("eval",), kind="deploy", serving=sv),
        T("update", w, epochs=1, batch_size=512, samples=2048,
          deps=("deploy",), kind="online_update", warm_start_from="train"),
    ])
    plat = pk.platform.ServerlessPlatform(seed=0)
    res = pk.orchestrator.WorkflowOrchestrator(
        dag, goal(pk, budget=50.0, deadline=4000.0), plat,
        pk.stores.ObjectStore(), pk.stores.ParamStore(),
        space=pk.bayes_opt.ConfigSpace(max_workers=16), engine="event",
        seed=0).run()
    assert set(res.tasks) == {"train", "eval", "deploy", "update"}
    srv = res.serving["deploy"]
    assert srv.requests > 0 and srv.batches > 0
    assert res.finish_s["eval"] <= res.start_s["deploy"]
    assert res.finish_s["deploy"] <= res.start_s["update"] + 1e-9
    assert res.tasks["deploy"].wall_s == pytest.approx(srv.wall_s)
    assert plat.ledger.job_usd["deploy"] == pytest.approx(srv.cost_usd)
    assert res.cost_usd == pytest.approx(
        sum(r.total_cost for r in res.tasks.values()))
    kinds = [line.split(" ", 1)[1] for line in res.trace]
    assert any(k.startswith("serve deploy") for k in kinds)
    assert any(k.startswith("served deploy") for k in kinds)
    return res, plat.ledger.job_usd


def test_every_reference_scenario_is_covered():
    src = (ROOT / "tests" / "test_workflow.py").read_text()
    names = sorted(line[len("def test_"):].split("(")[0]
                   for line in src.splitlines() if line.startswith("def test_"))
    assert names == sorted(SCENARIOS) and len(names) == 16


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_workflow_scenario_matches_reference(name):
    same(SCENARIOS[name](REF), SCENARIOS[name](PORT))


# -- the golden workflow trace -----------------------------------------------

def golden_tool():
    spec = importlib.util.spec_from_file_location(
        "golden_workflow_trace", ROOT / "tools" / "golden_workflow_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def golden_runs():
    tool = golden_tool()
    return tool, {pkg: tool.golden_text(pkg) for pkg in ("repro",
                                                          "repro_torch")}


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_golden_workflow_trace_reproduced_verbatim(golden_runs, pkg):
    tool, runs = golden_runs
    text, results = runs[pkg]
    assert text == tool.GOLDEN.read_text()
    hpo = results["hpo"]
    assert (hpo.wall_s, hpo.ledger_usd, len(hpo.trace)) == (
        1486.5402872616585, 1.4393586019392592, 51)
    assert hpo.winners["hpo"] == (1, 0.1385806875623638)


def test_golden_workflow_results_match_and_file_is_written_unchanged(
        golden_runs, tmp_path, monkeypatch, capsys):
    tool, runs = golden_runs
    same(runs["repro"][1], runs["repro_torch"][1])
    # the golden file's first workflow is test_workflow.py's hpo_workflow()
    dag, g, sweep = hpo_workflow(REF)
    res = orchestrate(REF, dag, g, engine="event", sweeps=[sweep])[1]
    assert res.trace == runs["repro"][1]["hpo"].trace
    # writing it from the reference leaves the checked-in bytes unchanged
    copy = tmp_path / "golden_workflow_trace.txt"
    copy.write_text(tool.GOLDEN.read_text())
    monkeypatch.setattr(tool, "GOLDEN", copy)
    monkeypatch.setattr(tool, "golden_text", lambda pkg: runs[pkg])
    assert tool.main([]) == 0
    assert "unchanged" in capsys.readouterr().out
    assert copy.read_text() == (ROOT / "tests" /
                                "golden_workflow_trace.txt").read_text()
    assert tool.main(["--check"]) == 0
