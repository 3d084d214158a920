"""Parity of the port's analytic worker model, platform and backends with
the JAX package's: the same arguments give equal results, compared with
``==`` (no tolerance)."""
import dataclasses
import math

import pytest

pytest.importorskip("torch")

from torch_sim_parity import PORT, REF, same  # noqa: E402

MEMORIES = (1024, 3008, 10240)
FLEET_SIZES = (4, 64)


def schemes(pk):
    """``ps``, ``scatter_reduce``, ``hier``, a compressed plan and a
    pipelined plan."""
    CommSpec = pk.comm.CommSpec
    return {"ps": "ps", "scatter_reduce": "scatter_reduce", "hier": "hier",
            "compressed": CommSpec("hier", ratio=0.05),
            "pipelined": CommSpec("scatter_reduce", pipeline_depth=4)}


def stores(pk):
    return pk.stores.ParamStore(), pk.stores.ObjectStore()


def iteration_times(pk, name, scheme, **kw):
    w = pk.worker.WORKLOADS[name]
    out = []
    for n in FLEET_SIZES:
        for mem in MEMORIES:
            out.append(pk.worker.iteration_time(
                w, schemes(pk)[scheme], n, mem, 64 * n, *stores(pk), **kw))
    return out


def test_workloads_are_the_same():
    assert list(REF.worker.WORKLOADS) == list(PORT.worker.WORKLOADS)
    for k in REF.worker.WORKLOADS:
        same(REF.worker.WORKLOADS[k], PORT.worker.WORKLOADS[k])
        assert (REF.worker.WORKLOADS[k].grad_bytes
                == PORT.worker.WORKLOADS[k].grad_bytes)


@pytest.mark.parametrize("scheme", ["ps", "scatter_reduce", "hier",
                                    "compressed", "pipelined"])
@pytest.mark.parametrize("name", ["resnet18", "resnet50", "bert-small",
                                  "bert-medium", "atari-rl"])
def test_iteration_time_and_comm_breakdown(name, scheme):
    assert sorted(REF.worker.WORKLOADS) == sorted(
        ["resnet18", "resnet50", "bert-small", "bert-medium", "atari-rl"])
    same(iteration_times(REF, name, scheme), iteration_times(PORT, name, scheme))
    w = REF.worker.WORKLOADS[name]
    for n in FLEET_SIZES:
        for mem in MEMORIES:
            got = [pk.worker.comm_breakdown(
                schemes(pk)[scheme], w.grad_bytes, n, mem, *stores(pk),
                extra_upload_bytes=w.extra_upload_bytes)
                for pk in (REF, PORT)]
            same(*got)
            assert got[0]


@pytest.mark.parametrize("scheme", ["ps", "hier", "pipelined"])
def test_iteration_time_on_a_mixed_fleet_and_vm_backends(scheme):
    def run(pk):
        fleet = pk.platform.FleetSpec.mixed([(6, 3008, "standard"),
                                             (2, 1024, "small")])
        out = [pk.platform.fleet_from_config(8, 3008, small_frac=0.25)]
        for name in pk.worker.WORKLOADS:
            out.append(iteration_times(pk, name, scheme, fleet=fleet))
            for backend in ("vm", "gpu_vm"):
                out.append(iteration_times(pk, name, scheme,
                                           backend=backend))
        return out
    same(run(REF), run(PORT))


def test_fleet_local_batches_and_compute_time():
    def run(pk):
        out = []
        for groups in ([(4, 2048, "a")], [(3, 1024, "a"), (5, 10240, "b")],
                       [(1, 128, "a"), (2, 1769, "b"), (7, 3008, "c")]):
            fleet = pk.platform.FleetSpec.mixed(groups)
            out.append((pk.worker.fleet_local_batches(fleet, 1000),
                        fleet.gflops_total(), fleet.gflops_harmonic(),
                        fleet.min_net_gbps(), fleet.total_memory_mb))
        w = pk.worker.WORKLOADS["bert-small"]
        out.append([pk.worker.compute_time(w, b, m)
                    for b in (1, 7.5, 64) for m in MEMORIES])
        out.append(pk.worker.compute_time(w, 8, 1024, gflops=360.0))
        return out
    same(run(REF), run(PORT))


def test_price_trace_and_spot():
    def run(pk):
        b = pk.backends
        tr = b.PriceTrace((0.0, 100.0, 250.0, 400.0, 520.0),
                          (0.10, 0.60, 0.15, 0.9, 0.12))
        out = [tr]
        for t in (0.0, 50.0, 100.0, 249.9, 250.0, 1e4):
            out.append((tr.price_at(t), tr.next_crossing_above(t, 0.3),
                        tr.next_drop_below(t, 0.3),
                        tr.integral_usd(t, t + 333.3),
                        tr.hazard_per_s(0.3, t, 600.0)))
        out.append(tr.mean_usd_per_hr)
        out.append([b.hazard_cadence_s(h, 2.0) for h in (0.0, 1e-4, 1.0)])
        for base in ("vm", "gpu_vm"):
            for policy in ("fallback", "wait"):
                spec = b.spot_variant(base, tr, bid_usd_per_hr=0.3,
                                      spot_policy=policy)
                out.append((spec, spec.usd_per_s, spec.expected_usd_per_s,
                            spec.gflops_for(2048), spec.net_gbps_for(2048)))
                for cadence in (None, 60.0):
                    out.append(b.simulate_spot_epoch(
                        900.0, spec, cadence_s=cadence, n_workers=4))
        out.append([b.resolve_backend(x) for x in
                    (None, "", "serverless", "vm", "gpu_vm")])
        with pytest.raises(ValueError):
            b.spot_variant("serverless", tr, bid_usd_per_hr=0.3)
        return out
    same(run(REF), run(PORT))


def test_serverless_platform_billing():
    def run(pk):
        p = pk.platform
        plat = p.ServerlessPlatform(failure_rate=0.3, seed=5)
        out = []
        for wid in range(6):
            rec = plat.invoke(wid, 150.0, 4.0)
            plat.advance(0.5)
            fails = [plat.iteration_fails() for _ in range(4)]
            recs = plat.finish(rec, 1024 * (wid + 1), rec.start + 400.0 * wid)
            out.append((fails, recs))
        plat.ledger.charge("store", 0.25)
        plat.ledger.charge_fleet(2048, 8, 1234.5, invocations_per_worker=3)
        plat.ledger.attribute("job", 1.5)
        out += [plat.invocations, plat.ledger, plat.ledger.lambda_cost,
                plat.ledger.total_cost, plat.now,
                [p.fn_gflops(m) for m in (128, 1769, 10240)],
                [p.fn_net_gbps(m) for m in (128, 1769, 10240)],
                p.ShockModel(interval_s=40.0, kill_frac=0.4)]
        return out
    same(run(REF), run(PORT))
    for k in ("LAMBDA_GB_SECOND", "LAMBDA_PER_REQUEST", "LAMBDA_MAX_DURATION_S",
              "MB_PER_VCPU", "PEAK_NET_GBPS", "PEAK_CPU_GFLOPS",
              "CHECKPOINT_RESTORE_S", "DATA_OBJECT_BYTES"):
        assert getattr(REF.platform, k) == getattr(PORT.platform, k), k
    assert dataclasses.astuple(REF.backends.BACKENDS["gpu_vm"]) == \
        dataclasses.astuple(PORT.backends.BACKENDS["gpu_vm"])
    assert math.isinf(PORT.backends.hazard_cadence_s(0.0, 2.0))
