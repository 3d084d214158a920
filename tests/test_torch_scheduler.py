"""Parity of the port's scheduler stack (Bayesian optimizer, cost model,
probe cache, throughput monitor, task scheduler on both engines) with the
JAX package's: the same arguments and seeds give equal results, compared
with ``==`` (no tolerance)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_sim_parity import PORT, REF, same  # noqa: E402

SPACES = {
    "plain": {},
    "fleet_comm_backend": dict(search_fleet=True, search_comm=True,
                               search_backend=True),
}


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("space", sorted(SPACES))
def test_bayesian_optimizer_proposals(space, constrained):
    def run(pk):
        bo = pk.bayes_opt.BayesianOptimizer(
            pk.bayes_opt.ConfigSpace(max_workers=120, **SPACES[space]),
            constraint_limit=600.0 if constrained else None, seed=7,
            n_candidates=128, max_iters=12)
        out = []
        while not bo.done():
            c = bo.suggest()
            obj = (c.workers - 40) ** 2 / 100.0 + abs(c.memory_mb - 3000) / 500
            con = 20000.0 / c.workers + c.memory_mb / 50.0
            bo.observe(c, obj, con if constrained else None)
            out.append(c)
        return out, bo.best(), bo.obs
    ref, port = run(REF), run(PORT)
    same(ref, port)
    assert len(port[0]) >= 4


def test_gp_and_expected_improvement():
    def run(pk):
        rng = np.random.RandomState(1)
        X, y = rng.random_sample((9, 3)), rng.randn(9)
        gp = pk.bayes_opt.GP().fit(X, y)
        mu, sig = gp.predict(rng.random_sample((50, 3)))
        return mu, sig, pk.bayes_opt.expected_improvement(mu, sig, y.min())
    same(run(REF), run(PORT))


CONFIGS = [(16, 2048, 0.0, "", 1.0, 0, 1, ""),
           (64, 3008, 0.25, "hier", 0.05, 8, 1, ""),
           (40, 10240, 0.5, "scatter_reduce", 1.0, 0, 4, ""),
           (8, 1024, 0.0, "ps", 0.1, 0, 2, "vm"),
           (4, 4096, 0.0, "", 1.0, 0, 1, "gpu_vm"),
           (12, 1536, 0.0, "", 1.0, 0, 1, "")]


@pytest.mark.parametrize("cached", [False, True])
def test_epoch_estimate_and_profile_cost(cached):
    def run(pk):
        cm = pk.cost_model
        cache = pk.probe_cache.ProbeCache() if cached else None
        out = []
        for name in ("bert-medium", "resnet18", "atari-rl"):
            w = pk.worker.WORKLOADS[name]
            for cfg in CONFIGS:
                c = pk.bayes_opt.Config(*cfg)
                for _ in range(2 if cached else 1):
                    ps, os_ = pk.stores.ParamStore(), pk.stores.ObjectStore()
                    if cache is None:
                        est = cm.epoch_estimate(w, "hier", c, 512, ps, os_,
                                                samples=200_000)
                        prof = cm.profile_cost(w, "hier", c, 512, ps, os_)
                    else:
                        est = cache.epoch_estimate(w, "hier", c, 512, ps,
                                                   os_, samples=200_000)
                        prof = cache.profile_cost(w, "hier", c, 512, ps, os_)
                    out.append((est, est.cost_usd, est.throughput, prof))
        if cache is not None:
            out.append((cache.hits, cache.misses, len(cache)))
        return out
    ref, port = run(REF), run(PORT)
    same(ref, port)
    if cached:
        assert port[-1][0] == port[-1][1] > 0


def test_goals_and_inflations():
    def run(pk):
        c = pk.constraints
        out = [c.compression_inflation(r) for r in (1.0, 0.1, 0.01)]
        out += [c.staleness_inflation(m, 2, 64)
                for m in ("bsp", "ssp", "ssp(3)", "async")]
        for g in (c.Goal("min_cost_deadline", deadline_s=100.0),
                  c.Goal("min_time_budget", budget_usd=5.0),
                  c.Goal("deadline_budget", deadline_s=200.0, budget_usd=5.0),
                  c.Goal("min_time"), c.Goal("min_cost")):
            out.append((g, g.objective_and_constraint(150.0, 4.0, 1.2)))
        return out
    same(run(REF), run(PORT))


def test_throughput_monitor():
    def run(pk):
        rng = np.random.RandomState(2)
        xs = np.concatenate([100 + rng.randn(60), 60 + rng.randn(60),
                             60 + 5 * rng.randn(40)])
        m = pk.monitor.ThroughputMonitor()
        alarms = [m.observe(float(x)) for x in xs]
        return alarms, m.mean, m
    ref, port = run(REF), run(PORT)
    same(ref, port)
    assert any(port[0])


GOALS = {
    "min_cost_deadline": (dict(deadline_s=3600.0), dict(stop_at_deadline=True)),
    "min_time_budget": (dict(budget_usd=4.0), dict(stop_at_budget=True)),
    "min_time": ({}, {}),
    "min_cost": ({}, {}),
    "deadline_budget": (dict(deadline_s=3600.0, budget_usd=20.0),
                        dict(stop_at_deadline=True, stop_at_budget=True)),
}


def scheduler(pk, engine, seed=0):
    opts = None
    if engine == "event":
        # a 4x slowdown partway through the epoch trips the monitor and a
        # mid-epoch re-optimization (tests/test_event_engine.py)
        opts = {"straggler_sigma": 0.1, "slowdown_at_iter": 20,
                "slowdown_factor": 4.0}
    plat = pk.platform.ServerlessPlatform(seed=seed)
    return pk.scheduler.TaskScheduler(
        plat, pk.stores.ObjectStore(), pk.stores.ParamStore(), seed=seed,
        space=pk.bayes_opt.ConfigSpace(max_workers=64), engine=engine,
        engine_opts=opts), plat


def plans(pk, engine):
    w = pk.worker.WORKLOADS["bert-small"]
    samples = 120_000 if engine == "event" else 50_000
    return [pk.scheduler.EpochPlan(b, w, samples=samples)
            for b in (1024, 1024, 2048)]


def summary(res, plat):
    return (res.wall_s, res.total_cost, res.profile_usd, res.profile_s,
            res.epochs_done, res.config_history, res.stop_reason, res.events,
            plat.ledger, len(plat.invocations))


@pytest.mark.parametrize("engine", ["analytic", "event"])
@pytest.mark.parametrize("kind", sorted(GOALS))
def test_task_scheduler_run(kind, engine):
    def run(pk):
        limits, stops = GOALS[kind]
        sched, plat = scheduler(pk, engine)
        res = sched.run(plans(pk, engine),
                        pk.constraints.Goal(kind, **limits), **stops)
        return summary(res, plat), res
    (ref, _), (port, res) = run(REF), run(PORT)
    same(ref, port)
    assert res.events and res.stop_reason
    if engine == "event" and kind in ("min_time", "min_cost"):
        assert "reoptimize_mid" in [e.kind for e in res.events]


@pytest.mark.parametrize("engine", ["analytic", "event"])
def test_task_scheduler_drive_and_resume(engine):
    """``drive`` run by hand (each engine request built and run here),
    two slices through ``resume``, and a fixed-config baseline."""
    def run(pk):
        goal = pk.constraints.Goal("min_time")
        sched, plat = scheduler(pk, engine, seed=3)
        gen = sched.drive(plans(pk, engine), goal, max_epochs=2)
        requests = []
        try:
            req = next(gen)
            while True:
                requests.append(req.at_t)
                req = gen.send(req.build().run())
        except StopIteration as stop:
            first = stop.value
        rest = sched.run(plans(pk, engine), goal, resume=first.state)
        sched2, plat2 = scheduler(pk, engine, seed=3)
        fixed = sched2.run(plans(pk, engine), goal, adaptive=False,
                           fixed_config=pk.bayes_opt.Config(32, 4096))
        return (requests, summary(first, plat), summary(rest, plat),
                summary(fixed, plat2))
    ref, port = run(REF), run(PORT)
    same(ref, port)
    assert (len(port[0]) > 0) == (engine == "event")


# ---------------------------------------------------------------------------
# the port's scheduler examples against the reference's
# ---------------------------------------------------------------------------

EXAMPLES = __import__("pathlib").Path(__file__).resolve().parents[1] / "examples"


def reference_example(name):
    """The JAX package's ``examples/<name>.py``, loaded as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_scheduler_and_kernel_layers_on_cpu(capsys):
    """Layers 2 and 3 of the port's quickstart (--device cpu): Scenario 1
    equals the reference quickstart's run, built by the reference examples'
    own ``fresh_scheduler``; the aggregation wrapper on a CPU tensor is its
    plain version."""
    from repro_torch.examples import quickstart
    res = quickstart.scheduler_scenario()
    assert quickstart.kernel_check("cpu") == 0.0
    out = capsys.readouterr().out
    assert "deployed {(" in out and "allclose OK" in out

    from repro.core import EpochPlan, Goal
    from repro.serverless import WORKLOADS
    sched, plat = reference_example("nas_dynamic").fresh_scheduler("hier")
    want = sched.run([EpochPlan(1024, WORKLOADS["bert-small"],
                                samples=30_000) for _ in range(3)],
                     Goal("min_cost_deadline", deadline_s=3600.0),
                     stop_at_deadline=True)
    same((want.wall_s, want.total_cost, want.profile_usd,
          want.config_history, want.stop_reason, want.events),
         (res.wall_s, res.total_cost, res.profile_usd, res.config_history,
          res.stop_reason, res.events))
    assert res.wall_s <= 3600.0


def test_scheduler_examples_print_what_the_reference_prints(capsys,
                                                            monkeypatch):
    """nas_dynamic and deadline_budget's three scenarios print the same
    text as the reference's examples (every number in them), and Scenario
    3's ``WorkflowResult`` equals the reference's ``run_workflow``'s."""
    import argparse
    from repro_torch.examples import deadline_budget, nas_dynamic
    reference_example("nas_dynamic").main()
    want = capsys.readouterr().out
    adaptive, fixed, nas = nas_dynamic.main()
    assert capsys.readouterr().out == want
    assert len(adaptive.config_history) == 6 and len(nas.events) > 12

    monkeypatch.setattr("sys.argv", ["deadline_budget.py"])
    ref = reference_example("deadline_budget")
    ref.main()
    want = capsys.readouterr().out
    res1, res2, res3 = deadline_budget.main([])
    got = capsys.readouterr().out
    assert "Scenario 3" in got and got == want
    args = argparse.Namespace(deadline=3600.0, budget=50.0,
                              model="bert-medium", epochs=6, samples=25_000)
    want3, goal3 = ref.run_workflow(args)
    same(want3, res3)
    assert list(res3.tasks) == ["train", "finetune", "eval"]
    assert res3.wall_s <= goal3.deadline_s
    assert res3.ledger_usd <= goal3.budget_usd
