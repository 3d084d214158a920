"""Parity of the port's inference arrival processes and SLO-aware batcher
with the JAX package's: the same arguments and seeds give equal results,
compared with ``==`` (no tolerance)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_sim_parity import PORT, REF, same  # noqa: E402

FLOPS_PER_REQ = 2e9

SPECS = {
    "diurnal": dict(base_rps=30.0, period_s=600.0, amplitude=0.8),
    "bursty": dict(base_rps=10.0, period_s=3600.0, bursts_per_hour=40.0,
                   burst_s=20.0, burst_multiplier=5.0),
    "quiet": dict(base_rps=0.05),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_request_stream_draws(name):
    def run(pk):
        a = pk.arrivals
        spec = a.ArrivalSpec(**SPECS[name])
        rs = a.RequestStream(spec, seed=9)
        out = [spec, spec.mean_rps(), spec.expected_requests(300.0),
               [rs.rate(t) for t in (0.0, 77.7, 450.0)]]
        for t0, horizon, slice_s in ((0.0, 300.0, 1.0), (1234.5, 120.0, 0.25)):
            out.append(rs.arrivals(t0, horizon, slice_s))
        task = a.ServingTask(pk.batcher.ServePolicy(8, 0.2, 2048), spec,
                             duration_s=60.0, flops_per_request=FLOPS_PER_REQ)
        out.append(task.estimate())
        return out
    ref, port = run(REF), run(PORT)
    same(ref, port)
    if name != "quiet":
        assert len(port[4]) > 100


@pytest.mark.parametrize("policy", [(1, 0.01, 4096), (8, 0.2, 2048),
                                    (32, 1.0, 1024)])
def test_batcher_simulate(policy):
    def run(pk):
        b = pk.batcher
        pol = b.ServePolicy(*policy)
        arr = np.sort(np.random.RandomState(3).uniform(0.0, 60.0, size=600))
        return ([b.simulate(pol, arrival_rate=rate,
                            flops_per_request=FLOPS_PER_REQ, seed=seed,
                            keep_records=True)
                 for rate in (0.5, 5.0, 50.0) for seed in (0, 1)]
                + [b.simulate(pol, arrival_rate=10.0,
                              flops_per_request=FLOPS_PER_REQ, arrivals=arr,
                              keep_records=True),
                   [b.exec_time(FLOPS_PER_REQ, k, pol.memory_mb)
                    for k in (1, 8, 32)]])
    same(run(REF), run(PORT))


# the reference's grid at a light load; a thinned grid where each of its
# simulations serves thousands of requests
SMALL_GRID = dict(batches=(1, 8, 32), timeouts=(0.05, 0.25),
                  memories=(2048, 8192))


@pytest.mark.parametrize("rate,slo,grid", [(2.0, 1.0, {}),
                                           (30.0, 1.0, SMALL_GRID),
                                           (5.0, 0.01, SMALL_GRID)])
def test_optimize_policy(rate, slo, grid):
    def run(pk):
        return pk.batcher.optimize_policy(arrival_rate=rate,
                                          flops_per_request=FLOPS_PER_REQ,
                                          slo_s=slo, **grid)
    ref, port = run(REF), run(PORT)
    same(ref, port)
    assert port[2]["evaluated"] > 0
    assert (port[0] is None) == (slo < 0.1)   # the tight SLO is infeasible
