"""Parity of the port's discrete-event engine with the JAX package's: the
golden trace byte for byte, and same-seed ``EngineResult``s and
``ServingResult``s equal with ``==`` (wall, cost, invocations, restarts,
per-iteration times, trace: every field)."""
import dataclasses
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

from test_engine_invariants import _check_invariants  # noqa: E402
from torch_sim_parity import BOTH, PORT, REF, same  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden_engine_trace.txt"
BATCH = 512
SAMPLES = 3 * BATCH


def golden_engine(pk):
    """tests/test_engine_invariants.py::_golden_engine, from ``pk``."""
    s = pk.stores
    return pk.events.EventEngine(pk.worker.WORKLOADS["resnet18"], "hier", 2,
                                 2048, 512, s.ParamStore(), s.ObjectStore(),
                                 samples=1024, straggler_sigma=0.3, seed=42)


def test_port_golden_trace_reproduced_verbatim():
    a = golden_engine(PORT).run()
    b = golden_engine(PORT).run()
    text_a = "\n".join(a.trace) + "\n"
    assert text_a == "\n".join(b.trace) + "\n"
    assert text_a == GOLDEN.read_text()
    same(a, golden_engine(REF).run())


def build(pk, *, scheme="hier", n=6, mem=2048, sigma=0.0, failure_rate=0.0,
          sync_mode="bsp", hetero=False, shocked=False, seed=3, depth=1,
          backend=None, workload="resnet18", **kw):
    """An engine as tests/test_engine_invariants.py::_build makes it."""
    p = pk.platform
    if depth > 1:
        scheme = dataclasses.replace(pk.comm.parse_scheme(scheme),
                                     pipeline_depth=depth)
    plat = p.ServerlessPlatform(seed=0)
    fleet = None
    if hetero:
        fleet = p.FleetSpec.mixed([(n - n // 2, mem, "standard"),
                                   (n // 2, max(mem // 2, 512), "small")])
    shocks = p.ShockModel(interval_s=40.0, kill_frac=0.4) if shocked else None
    eng = pk.events.EventEngine(
        pk.worker.WORKLOADS[workload], scheme, n, mem, BATCH,
        pk.stores.ParamStore(), pk.stores.ObjectStore(), samples=SAMPLES,
        straggler_sigma=sigma, failure_rate=failure_rate,
        sync_mode=sync_mode, fleet=fleet, shocks=shocks, platform=plat,
        seed=seed, backend=backend, **kw)
    return eng, plat


CASES = {
    "plain": {},
    "failures": dict(failure_rate=0.2, seed=11),
    "cap_restarts": dict(workload="bert-medium", mem=1024),
    "shocks": dict(shocked=True, seed=5),
    "mixed_fleet": dict(hetero=True, n=7),
    "no_coalesce": dict(coalesce=False),
    "pipelined_ps": dict(scheme="ps", depth=4),
    "vm": dict(backend="vm"),
}


@pytest.mark.parametrize("sigma", [0.0, 0.3])
@pytest.mark.parametrize("sync_mode", ["bsp", "ssp(2)", "async"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_same_seed_engine_results_equal(case, sync_mode, sigma):
    runs = []
    for pk in BOTH:
        eng, plat = build(pk, sigma=sigma, sync_mode=sync_mode, **CASES[case])
        r = eng.run()
        runs.append((r, plat.invocations, plat.ledger))
        if pk is PORT and "backend" not in CASES[case]:
            _check_invariants(eng, plat, r)     # the Lambda bookkeeping
    same(*runs)
    assert runs[1][0].trace and runs[1][0].iters_done == 3


def test_two_engine_contention_domain():
    def run(pk):
        shared = pk.stores.ParamStore()
        dom = pk.events.ContentionDomain()
        plats = [pk.platform.ServerlessPlatform(seed=0) for _ in range(2)]
        engs = [pk.events.EventEngine(
            pk.worker.WORKLOADS["resnet18"], "ps", 6, 2048, BATCH, shared,
            pk.stores.ObjectStore(), samples=SAMPLES, straggler_sigma=0.2,
            seed=i, platform=plats[i], domain=dom) for i in range(2)]
        dom.run()
        if pk is PORT:
            for e, plat in zip(engs, plats):
                _check_invariants(e, plat, e.result())
        return ([e.result() for e in engs], dom.sync_union_s,
                shared.alive_seconds)
    same(run(REF), run(PORT))


def test_serving_job_under_request_stream_traffic():
    def run(pk):
        spec = pk.arrivals.ArrivalSpec(base_rps=20.0, period_s=600.0,
                                       bursts_per_hour=60.0, burst_s=10.0,
                                       burst_multiplier=4.0)
        arr = pk.arrivals.RequestStream(spec, seed=4).arrivals(0.0, 90.0)
        pol = pk.batcher.ServePolicy(8, 0.1, 3072)
        job = pk.events.ServingJob(
            pol, arr, 2e9, pk.stores.ParamStore(), pk.stores.ObjectStore(),
            model_bytes=4.4e8, code_bytes=20e6, cold_start_s=1.0,
            keep_warm_s=30.0, max_instances=16, refresh_every_s=1.0)
        return arr, job.run()
    ref, port = run(REF), run(PORT)
    same(ref, port)
    assert port[1].requests == len(port[0]) > 0


def test_serving_job_contends_with_training_on_one_domain():
    def run(pk):
        dom = pk.events.ContentionDomain()
        ps = pk.stores.ParamStore()
        w = pk.worker.WORKLOADS["bert-medium"]
        t = pk.events.EventEngine(w, "ps", 8, 3072, 1024, ps,
                                  pk.stores.ObjectStore(), samples=3000,
                                  seed=1, domain=dom, trace_enabled=False)
        arr = np.sort(np.random.RandomState(11).uniform(0.0, 30.0, size=300))
        s = pk.events.ServingJob(pk.batcher.ServePolicy(8, 0.1, 3072), arr,
                                 2e9, ps, pk.stores.ObjectStore(), domain=dom,
                                 model_bytes=w.param_count * 4.0,
                                 code_bytes=20e6, cold_start_s=1.0,
                                 keep_warm_s=30.0, max_instances=16,
                                 refresh_every_s=1.0)
        dom.run()
        return t.result(), s.result()
    same(run(REF), run(PORT))


def test_calendar_queue_pop_order():
    def run(pk):
        rng = np.random.RandomState(7)
        q = pk.events.CalendarQueue()
        seq, popped = 0, []
        for _ in range(3000):
            if len(q) and rng.random_sample() < 0.4:
                popped.append(q.pop())
            else:
                t = float(rng.random_sample() * 10.0 ** rng.randint(-3, 6))
                q.push((t, seq, None, None))
                seq += 1
        while q:
            popped.append(q.pop())
        return popped
    ref, port = run(REF), run(PORT)
    assert port == ref and len(port) > 1000
