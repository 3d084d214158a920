"""The port's spans (``repro_torch.core.spans``): off they record and
allocate nothing; on, under a profiler or inside ``recording()``, each is
a named range of the profiler's trace and a record with its parent and
its times; the training steps and the serving engine record the spans
their layers have; and the numbers the program computes are the same
bits with the spans on and off."""
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced, reduced_batch  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ACTS = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _empty():
    spans.clear()
    yield
    spans.clear()


def _names():
    return [s.name for s in spans.finished()]


def _count(name):
    return sum(s.name == name for s in spans.finished())


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------


def test_off_records_nothing_and_returns_the_shared_null_context():
    a, b = spans.span("a"), spans.span("b")
    assert a is b is spans._NULL
    with spans.span("a"):
        pass
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in range(1000):
            with spans.span("off"):
                pass
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak - base < 512
    assert spans.finished() == [] and spans.dropped() == 0


def _nest():
    with spans.span("outer"):
        with spans.span("inner.a"):
            torch.ones(4).sum()
        with spans.span("inner.b"):
            with spans.span("leaf"):
                torch.ones(4).sum()


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_names_parents_and_start_order(how):
    with torch.profiler.profile(activities=ACTS) as prof:
        if how == "recording":
            with spans.recording():
                _nest()
        else:
            _nest()
    got = spans.finished()
    assert [s.name for s in got] == ["outer", "inner.a", "inner.b", "leaf"]
    ids = [s.id for s in got]
    assert ids == sorted(ids)
    outer, a, b, leaf = got
    assert outer.parent is None
    assert a.parent == b.parent == outer.id and leaf.parent == b.id
    for s in got:
        assert s.host_start_ns <= s.host_end_ns and s.device_ms >= 0
    assert outer.host_start_ns <= a.host_start_ns <= b.host_end_ns \
        <= outer.host_end_ns
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in got:       # a host operator's range: the profiler puts no
        e = ranges[s.name]          # copy of it on the device's timeline
        assert str(e.device_type()).endswith("CPU")
        assert not e.is_user_annotation()
    assert ranges["outer"].start_ns() <= ranges["leaf"].start_ns() \
        <= ranges["leaf"].end_ns() <= ranges["outer"].end_ns()
    # outside both, spans are off again
    assert spans.span("after") is spans._NULL


def test_an_exception_closes_its_span():
    with spans.recording():
        with pytest.raises(ValueError):
            with spans.span("outer"):
                with spans.span("fails"):
                    raise ValueError("inside")
        with spans.span("next"):
            pass
    got = {s.name: s for s in spans.finished()}
    assert set(got) == {"outer", "fails", "next"}
    assert got["fails"].parent == got["outer"].id
    assert got["next"].parent is None


def test_the_buffer_keeps_the_newest_and_counts_the_dropped():
    extra = 3
    with spans.recording():
        for i in range(spans.CAP + extra):
            with spans.span(f"s{i}"):
                pass
    got = spans.finished()
    assert len(got) == spans.CAP and spans.dropped() == extra
    assert got[0].name == f"s{extra}" and got[-1].name == f"s{spans.CAP + 2}"
    spans.clear()
    assert spans.finished() == [] and spans.dropped() == 0


# ---------------------------------------------------------------------------
# the spans of the training steps and the engine, and the same bits
# ---------------------------------------------------------------------------


def _tiny():
    cfg = reduced(ARCHS["olmo-1b"]).replace(n_layers=1, d_model=64)
    batch = T.from_numpy(reduced_batch(cfg, batch=4, seq=16), "cpu")
    return cfg, registry.init(0, cfg, "cpu"), batch


def _pool_steps(on: bool, steps: int = 2):
    from repro_torch.optim import AdamW
    from repro_torch.serverless import LocalWorkerPool, ParamStore
    cfg, params, batch = _tiny()
    pool = LocalWorkerPool(
        T.grad(lambda p, b: registry.loss_fn(p, cfg, b)), 2, ParamStore(),
        use_kernel=True, plan="scatter_reduce")
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    for _ in range(steps):
        if on:
            with spans.recording():
                grads = pool.step(params, batch)
                params, state = opt.update(grads, state, params)
        else:
            grads = pool.step(params, batch)
            params, state = opt.update(grads, state, params)
    return params


def test_pool_step_records_its_spans():
    _pool_steps(True, steps=1)
    counts = {n: _count(n) for n in (
        "autograd.forward", "autograd.backward", "exchange.flatten",
        "exchange.aggregate", "adamw.update", "loss.cross_entropy")}
    assert counts == {"autograd.forward": 2, "autograd.backward": 2,
                      "exchange.flatten": 2, "exchange.aggregate": 1,
                      "adamw.update": 1, "loss.cross_entropy": 2}
    got = spans.finished()
    by_id = {s.id: s for s in got}
    for s in got:      # the loss runs inside the forward, nothing else nests
        want = "autograd.forward" if s.name == "loss.cross_entropy" else None
        assert (by_id[s.parent].name if s.parent is not None
                else None) == want
    assert [s.name for s in got if s.parent is None] == [
        "autograd.forward", "autograd.backward", "exchange.flatten"] * 2 + [
        "exchange.aggregate", "adamw.update"]


def _hier_steps(on: bool, steps: int = 2):
    from repro_torch.launch.mesh import process_group
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_local_mesh
    from repro_torch.optim import AdamW
    cfg, params, batch = _tiny()
    with process_group("cpu"):
        step = make_train_step(cfg, make_local_mesh("cpu"), strategy="hier",
                               optimizer=AdamW(lr=1e-2))
        p = step.shard_params(params)
        state = step.init_opt_state(p)
        losses = []
        for _ in range(steps):
            if on:
                with spans.recording():
                    p, state, loss = step(p, state, step.local_batch(batch))
            else:
                p, state, loss = step(p, state, step.local_batch(batch))
            losses.append(loss)
        return step.gather_params(p), losses


def test_hier_step_records_both_exchange_spans():
    _hier_steps(True, steps=1)
    assert [n for n in _names() if n != "loss.cross_entropy"] == [
        "autograd.forward", "autograd.backward", "exchange.reduce_scatter",
        "adamw.update", "exchange.all_gather"]
    assert _count("loss.cross_entropy") == 1


def test_engine_records_a_prefill_and_each_decode_step():
    from repro_torch.serving import Request, ServingEngine
    cfg, params, _ = _tiny()
    eng = ServingEngine(cfg, params=params, device="cpu")
    gen = 5
    x = np.arange(2 * 8, dtype=np.int32).reshape(2, 8) % cfg.vocab_size
    with spans.recording():
        eng.serve_batch([Request(r, x[r], gen) for r in range(2)])
    assert _names() == ["serve.prefill"] + ["serve.decode_step"] * (gen - 1)
    assert set(eng.last_stats) == {"batch", "prompt_len", "new_tokens",
                                   "prefill_s", "decode_s"}


def _bits(tree):
    return [(p, x.dtype, x.view(torch.uint8 if x.element_size() == 1 else {
        2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])
        .tolist()) for p, x in T.leaves_with_path(tree)]


def test_spans_on_and_off_give_the_same_bits():
    assert _bits(_pool_steps(True)) == _bits(_pool_steps(False))
    (p_on, l_on), (p_off, l_off) = _hier_steps(True), _hier_steps(False)
    assert _bits(p_on) == _bits(p_off)
    assert [float(x) for x in l_on] == [float(x) for x in l_off]
    from repro_torch.serving import Request, ServingEngine
    cfg, params, _ = _tiny()
    eng = ServingEngine(cfg, params=params, device="cpu")
    x = (np.arange(3 * 12, dtype=np.int32).reshape(3, 12) * 7) \
        % cfg.vocab_size
    reqs = [Request(r, x[r], 6) for r in range(3)]
    with spans.recording():
        on = [c.tokens.tolist() for c in eng.serve_batch(reqs)]
    off = [c.tokens.tolist() for c in eng.serve_batch(reqs)]
    assert on == off
