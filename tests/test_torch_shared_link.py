"""The port's ``SharedLink`` (``repro_torch/serverless/stores.py``): its
class-based incremental water-filling against its materialized fallback
(``incremental=False``), as ``tests/test_shared_link.py`` holds the
reference's, and the port's rates, completion times and engine results
against the reference's with ``==``:

  - per-flow rates bit-equal to the materialized fallback's and to the
    reference's over random (cap, prio, weight) mixes and random
    add/advance/remove interleavings;
  - flows complete in the same order at the same times (the materialized
    path at 1e-12 rel, as the reference's test; the reference's class path
    exactly);
  - an engine on the class path equals the same engine forced onto the
    materialized path, and the reference's engine exactly;
  - same-seed runs are bit-identical (heterogeneous fleet, serving,
    co-scheduled train + serve), and equal the reference's;
  - the post-join drain cascade engages and changes nothing.

Property tests use hypothesis when available and fall back to a
fixed-seed random sweep otherwise, as the reference's."""
import os
import sys

import numpy as np
import pytest

from repro.serverless import WORKLOADS as J_WORKLOADS
from repro.serverless import EventEngine as JEngine
from repro.serverless import FleetSpec as JFleet
from repro.serverless import ObjectStore as JObjectStore
from repro.serverless import ParamStore as JParamStore
from repro.serverless import ServingJob as JServingJob
from repro.serverless.events import ContentionDomain as JDomain
from repro.serverless.events import _Transfer as JTransfer
from repro.serverless.stores import SharedLink as JSharedLink
from repro.serving import ServePolicy as JServePolicy
from repro_torch.serverless import (WORKLOADS, EventEngine, FleetSpec,
                                    ObjectStore, ParamStore, ServingJob)
from repro_torch.serverless.events import ContentionDomain, _Transfer
from repro_torch.serverless.stores import SharedLink
from repro_torch.serving import ServePolicy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_sim_parity import same  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st

    def sweep(test):
        return settings(max_examples=30, deadline=None)(
            given(st.integers(min_value=0, max_value=2**31 - 1))(test))
except ImportError:                                   # fallback shim
    def sweep(test):
        def run():
            for seed in np.random.RandomState(1234).randint(
                    0, 2**31 - 1, size=30):
                test(int(seed))
        run.__name__ = test.__name__
        run.__doc__ = test.__doc__
        return run


CAPS = [0.05, 0.1, 0.4, None]      # None -> link per-stream default
PRIOS = [1.0, 2.0, 4.0]
PORT = dict(engine=EventEngine, fleet=FleetSpec, workloads=WORKLOADS,
            param=ParamStore, obj=ObjectStore, job=ServingJob,
            domain=ContentionDomain, policy=ServePolicy)
REF = dict(engine=JEngine, fleet=JFleet, workloads=J_WORKLOADS,
           param=JParamStore, obj=JObjectStore, job=JServingJob,
           domain=JDomain, policy=JServePolicy)


def _mk_links():
    """The port's class path and materialized path, and the reference's
    class path, on one link's settings."""
    kw = dict(aggregate_gbps=1.0, per_stream_gbps=0.8, latency_s=0.0)
    return (SharedLink("a", **kw), SharedLink("b", incremental=False, **kw),
            JSharedLink("a", **kw))


def _mk_flows(rng, links):
    """One flow of a random (size, cap, prio, weight) on each link."""
    size = float(rng.uniform(1e6, 5e8))
    cap = CAPS[rng.randint(len(CAPS))]
    prio = PRIOS[rng.randint(len(PRIOS))]
    weight = int(rng.randint(1, 4))
    return [(JTransfer if isinstance(link, JSharedLink) else _Transfer)(
        link, size, 0.0, lambda: None, False, cap_gbps=cap, prio=prio,
        weight=weight) for link in links]


@sweep
def test_rates_bit_equal_to_materialized_and_reference(seed):
    """Random add/advance/remove interleavings: the class path's per-flow
    rates equal the materialized fallback's and the reference's, bit for
    bit, at every step."""
    rng = np.random.RandomState(seed)
    links = _mk_links()
    live = []
    now = 0.0
    for _ in range(40):
        op = rng.rand()
        if op < 0.55 or not live:
            flows = _mk_flows(rng, links)
            for link, tr in zip(links, flows):
                link.add_flow(tr, now)
            live.append(flows)
        elif op < 0.8:
            now += float(rng.uniform(0.0, 0.5))
            for link in links:
                link.progress(now)
        else:
            flows = live.pop(rng.randint(len(live)))
            for link, tr in zip(links, flows):
                link.remove_flow(tr, now)
        rates = [link.rates() for link in links]
        for flows in live:
            got = [r[tr.fid] for r, tr in zip(rates, flows)]
            assert got[0] == got[1] == got[2]
        assert sum(rates[0].values()) == sum(rates[2].values())


@sweep
def test_completion_order_matches_materialized_and_reference(seed):
    """Draining the links to empty: the same completion order at the same
    times (1e-12 rel against the materialized path, whose served integral
    sums in another association order; exact against the reference)."""
    rng = np.random.RandomState(seed)
    links = _mk_links()
    order = {}
    now = 0.0
    for _ in range(12):
        flows = _mk_flows(rng, links)
        for link, tr in zip(links, flows):
            link.add_flow(tr, now)
        order[flows[0].fid] = (flows[1].fid, flows[2].fid)
        now += float(rng.uniform(0.0, 0.2))
        for link in links:
            link.progress(now)
    inc, mat, ref = links
    guard = 0
    while inc.flows:
        dts = [link.next_completion_dt() for link in links]
        assert dts[0] == pytest.approx(dts[1], rel=1e-12, abs=1e-15)
        assert dts[0] == dts[2]
        now += dts[0]
        for link in links:
            link.progress(now)
        done = [link.take_drained(eps_gb=1e-9) for link in links]
        # a same-instant batch is a set: the class path yields per-class
        # heap order, the materialized path insertion order
        assert (sorted(order[t.fid][0] for t in done[0])
                == sorted(t.fid for t in done[1]))
        assert [order[t.fid][1] for t in done[0]] == \
            [t.fid for t in done[2]]
        guard += 1
        assert guard < 100
    assert not mat.flows and not ref.flows


def _hetero_engine(pk, incremental, *, sigma=0.3, seed=9):
    fleet = pk["fleet"].mixed([(5, 2048, "standard"), (3, 3072, "large")])
    eng = pk["engine"](pk["workloads"]["resnet18"], "hier", 8, 2048, 4096,
                       pk["param"](), pk["obj"](), samples=3 * 4096,
                       fleet=fleet, straggler_sigma=sigma, seed=seed)
    if not incremental:
        for link in eng.links.values():
            link.incremental = False       # force the materialized path
    return eng


def test_hetero_engine_class_path_equals_materialized_path():
    """A mixed-cap sigma > 0 run on the class-based links equals the same
    run forced onto the materialized path, and the reference's run."""
    a = _hetero_engine(PORT, True).run()
    b = _hetero_engine(PORT, False).run()
    assert a.iters_done == b.iters_done
    assert a.invocations == b.invocations
    assert a.wall_s == pytest.approx(b.wall_s, rel=1e-9)
    assert a.lambda_usd == pytest.approx(b.lambda_usd, rel=1e-9)
    assert a.store_usd == pytest.approx(b.store_usd, rel=1e-9)
    assert a.iter_times == pytest.approx(b.iter_times, rel=1e-9)
    assert len(a.trace) == len(b.trace)
    same(a, _hetero_engine(REF, True).run())


def test_hetero_same_seed_bit_identity():
    a = _hetero_engine(PORT, True).run()
    b = _hetero_engine(PORT, True).run()
    assert a.wall_s == b.wall_s
    assert a.lambda_usd == b.lambda_usd
    assert a.store_usd == b.store_usd
    assert a.iter_times == b.iter_times
    assert a.trace == b.trace
    assert a.sim_events == b.sim_events
    same(a, _hetero_engine(REF, True).run())


def _serving_job(pk, ps=None, dom=None, prio=1.0):
    pol = pk["policy"](4, 0.1, 2048)
    arr = np.sort(np.random.RandomState(3).uniform(0.0, 20.0, size=300))
    return pk["job"](pol, arr, 2e9, ps or pk["param"](), pk["obj"](),
                     domain=dom, model_bytes=100e6, code_bytes=10e6,
                     cold_start_s=0.5, keep_warm_s=10.0, max_instances=8,
                     refresh_every_s=2.0, link_priority=prio)


def test_serving_same_seed_bit_identity():
    a = _serving_job(PORT).run()
    b = _serving_job(PORT).run()
    assert (a.wall_s, a.lambda_usd, a.store_usd, a.p50_s, a.p99_s) == \
           (b.wall_s, b.lambda_usd, b.store_usd, b.p50_s, b.p99_s)
    assert a.sim_events == b.sim_events
    same(a, _serving_job(REF).run())


def _corun(pk):
    """Train + serve on one ParamStore in one domain: two (cap, prio)
    classes on the shared param link."""
    dom = pk["domain"]()
    ps = pk["param"]()
    eng = pk["engine"](pk["workloads"]["resnet18"], "ps", 8, 2048, 4096,
                       ps, pk["obj"](), samples=2 * 4096, seed=4,
                       domain=dom, trace_enabled=False)
    job = _serving_job(pk, ps, dom, prio=4.0)
    dom.run()
    return eng.result(), job.result()


def test_multi_job_same_seed_bit_identity():
    """The co-run is repeatable bit for bit, and equals the reference's."""
    ta, sa = _corun(PORT)
    tb, sb = _corun(PORT)
    assert (ta.wall_s, ta.lambda_usd, ta.store_usd) == \
           (tb.wall_s, tb.lambda_usd, tb.store_usd)
    assert (sa.wall_s, sa.p99_s, sa.cost_usd) == (sb.wall_s, sb.p99_s,
                                                  sb.cost_usd)
    rt, rs = _corun(REF)
    same(ta, rt)
    same(sa, rs)


def test_drain_cascade_fires_and_is_exact():
    """Small compute spread + aggregate-bound drains: after the last
    member joins, the remaining drains cascade inline. The cascade must
    engage, and the run must equal the per-worker one (``coalesce=False``)
    and the reference's."""
    orig = ContentionDomain._cascade
    count = [0]

    def wrapped(self, link, c, win):
        count[0] += 1
        return orig(self, link, c, win)

    def run(pk, coalesce):
        return pk["engine"](pk["workloads"]["bert-medium"], "hier", 32,
                            2048, 256, pk["param"](), pk["obj"](),
                            samples=3 * 256, straggler_sigma=0.01, seed=7,
                            record_trace=False, coalesce=coalesce).run()

    ContentionDomain._cascade = wrapped
    try:
        a = run(PORT, None)
        assert count[0] > 0            # the cascade regime was exercised
        b = run(PORT, False)
    finally:
        ContentionDomain._cascade = orig
    assert a.iters_done == b.iters_done
    assert a.wall_s == pytest.approx(b.wall_s, rel=1e-9)
    assert a.lambda_usd == pytest.approx(b.lambda_usd, rel=1e-9)
    assert a.store_usd == pytest.approx(b.store_usd, rel=1e-9)
    assert a.iter_times == pytest.approx(b.iter_times, rel=1e-9)
    same(a, run(REF, None))
