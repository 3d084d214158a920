"""The port's dry run (``launch/dryrun.py``), its collective recorder
(``launch/hlo_stats.py``) and the kernels as custom ops with FLOP formulas:

- the recorder against the reference's HLO parser on the same result
  shapes (``tests/test_dryrun_tools.py``'s HLO), and its reduce-scatter
  and all-gather bytes in a traced reduced step against the sum over the
  sharding specs' split leaves;
- reduced configs of every family traced on fake "8x1" and "2x4x1" meshes
  for train, prefill and decode: every term finite and positive;
- at world size 1, the fake trace's FLOPs and peak equal ``FlopCounterMode``
  and the live-storage count on a real CPU step of the same program;
- ``smlt::flash_attention_fwd`` and ``smlt::ssd_scan`` through
  ``torch.library.opcheck``, each FLOP formula against its closed form;
- the CLI (per-pair JSON, exit 1 listing a failure) and ``launch/train.py
  --dry-run``."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.launch.hlo_stats import collective_stats  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.core.hier_sync import (all_gather, all_reduce,  # noqa: E402
                                        reduce_scatter)
from repro_torch.distributed.sharding import param_specs, placement  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo_stats  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_custom_mesh, process_group  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.base import InputShape  # noqa: E402

FAMILIES = ["olmo-1b", "mamba2-2.7b", "zamba2-7b", "qwen2-moe-a2.7b",
            "llama-3.2-vision-90b", "seamless-m4t-medium"]
KINDS = ["train", "prefill", "decode"]
SEQ = 32
SPLIT_MIN = 2 ** 12         # ZeRO-3 splits reduced leaves this large


@pytest.fixture(autouse=True)
def _split_reduced_leaves(monkeypatch):
    monkeypatch.setattr(steps, "FSDP_MIN_SIZE", SPLIT_MIN)


def _shape(kind, batch=16):
    return InputShape(f"{kind}_small", SEQ, batch, kind)


# tests/test_dryrun_tools.py's HLO: the results each collective gives
HLO = """
  %ag = bf16[16,512,1024]{2,1,0} all-gather(bf16[1,512,1024]{2,1,0} %p0), replica_groups={...}
  %ar.1 = f32[2048]{0} all-reduce(f32[2048]{0} %x), to_apply=%add
  %rs = (f32[128]{0}, f32[128]{0}) reduce-scatter(f32[2048]{0} %a, f32[2048]{0} %b), dimensions={0}
  %a2a = bf16[4,64]{1,0} all-to-all(bf16[4,64]{1,0} %y), dimensions={0}
  %cp = u32[8]{0} collective-permute(u32[8]{0} %z), source_target_pairs={{0,1}}
  %start = f32[64]{0} all-gather-start(f32[8]{0} %w)
  %done = f32[64]{0} all-gather-done(f32[64]{0} %start)
"""


def test_recorder_matches_reference_parser():
    """The port's collectives with the HLO's results (the tuple
    reduce-scatter as one of twice the size; all-to-all and
    collective-permute, which the port does not issue, recorded directly)
    give the reference parser's counts and bytes."""
    with D.fake_world(16):
        group = torch.distributed.group.WORLD
        with hlo_stats.CollectiveRecorder() as rec:
            all_gather(torch.empty(16, 512, 1024, dtype=torch.bfloat16),
                       torch.empty(1, 512, 1024, dtype=torch.bfloat16), group)
            all_reduce(torch.empty(2048), group)
            reduce_scatter(torch.empty(256), torch.empty(4096), group)
            hlo_stats.record("all-to-all",
                             torch.empty(4, 64, dtype=torch.bfloat16))
            hlo_stats.record("collective-permute",
                             torch.empty(8, dtype=torch.int32))
            all_gather(torch.empty(64), torch.empty(4), group)
    assert rec.stats() == collective_stats(HLO)
    assert rec.stats()["all-gather"]["bytes"] == 16 * 512 * 1024 * 2 + 64 * 4
    with pytest.raises(ValueError, match="unknown collective"):
        hlo_stats.record("all-gather-done", torch.empty(1))


@pytest.mark.parametrize("fsdp,remat", [(False, False), (True, False),
                                        (True, True)])
def test_step_collective_bytes_equal_split_leaves(fsdp, remat):
    """A reduced ``hier`` step on a fake "8x1" mesh: without ZeRO-3 the
    all-gathers move every leaf the hier specs split (min 2**14) once and
    the reduce-scatters 1/8 of it; with ZeRO-3 the ZeRO-3 leaves add their
    gathers (a stacked leaf once per layer, twice under remat, where the
    backward gathers again) and the gathers' reduce-scatters."""
    cfg = reduced(ARCHS["olmo-1b"])
    res = D.lower_one("olmo-1b", _shape("train"), multi_pod=False,
                      mesh_shape="8x1", device="cpu", cfg=cfg, fsdp=fsdp,
                      remat=remat)
    meta = registry.init(0, cfg, device="meta")
    zero = param_specs(meta, fsdp_axis=("data",), fsdp_min_size=SPLIT_MIN,
                       fsdp_divisor=8)
    hier = param_specs(meta, fsdp_axis="data", fsdp_min_size=2 ** 14,
                       fsdp_divisor=8)
    ag = rs = 0
    for path, x, z, h in zip([p for p, _ in T.leaves_with_path(meta)],
                             T.leaves(meta), T.leaves(zero), T.leaves(hier)):
        nbytes = x.numel() * x.element_size()
        if fsdp and placement(z) is not None:
            times = 2 if remat and path.startswith("blocks/") else 1
            ag, rs = ag + times * nbytes, rs + nbytes / 8
        elif placement(h) is not None:
            ag, rs = ag + nbytes, rs + nbytes / 8
    coll = res["collectives"]
    assert coll["all-gather"]["bytes"] == ag
    assert coll["reduce-scatter"]["bytes"] == rs


@pytest.mark.parametrize("mesh", ["8x1", "2x4x1"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_dryrun_terms_finite_and_positive(arch, kind, mesh):
    res = D.lower_one(arch, _shape(kind), multi_pod=False, mesh_shape=mesh,
                      device="cpu", cfg=reduced(ARCHS[arch]))
    assert res["mesh"] == mesh and res["device"] == "cpu"
    mem = res["memory"]
    terms = [res["flops"], res["bytes_accessed"], res["collective_bytes"],
             mem["argument_size_in_bytes"], mem["output_size_in_bytes"],
             mem["temp_size_in_bytes"], mem["peak_memory_in_bytes"],
             res["params"], res["active_params"], res["trace_s"] + 1]
    assert np.isfinite(terms).all() and min(terms) > 0, res
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"]
    assert res["collectives"]["all-gather"]["count"] > 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_world1_trace_equals_real_cpu_step(arch, kind):
    """One rank: the fake trace's FLOPs equal those of the same step run on
    real CPU tensors (seed-0 weights, zero batch), and its peak of live
    bytes lies within 5 % of the real step's: gloo's worker thread may
    hold a collective's buffers a moment past its wait (seen once: 62,976
    of 4.59 MB), which the fake process group never does."""
    shape = _shape(kind, batch=2)
    base = reduced(ARCHS[arch])
    res = D.lower_one(arch, shape, multi_pod=False, mesh_shape="1x1",
                      device="cpu", cfg=base)
    cfg = D.dryrun_config(arch, shape, cfg=base)
    with process_group("cpu"):
        mesh = make_custom_mesh("1x1", "cpu")
        step = D.make_step(cfg, shape, mesh)
        args = D.step_args(step, cfg, shape, device="cpu",
                           init=lambda p: registry.init(0, cfg, "cpu"))
        held = list(D._tensors(args))
        with FlopCounterMode(display=False) as flops, D.StepCounter() as c:
            c.track(held)
            step(*args)
    assert res["flops"] == flops.get_total_flops() > 0
    assert res["memory"]["peak_memory_in_bytes"] == pytest.approx(c.peak,
                                                                   rel=0.05)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_world1_kernel_prefill_trace_equals_real_cpu_step(arch):
    """A prefill from the zero state with the SSD kernel on: the fake
    trace holds ``smlt::ssd_scan`` once a Mamba2 layer at ``ssd_flops``
    a call, and its FLOPs equal the same step's on real CPU tensors."""
    shape = _shape("prefill", batch=2)
    base = reduced(ARCHS[arch])
    on = {"use_ssd_kernel": True}
    res = D.lower_one(arch, shape, multi_pod=False, mesh_shape="1x1",
                      device="cpu", cfg=base, overrides=on)
    cfg = D.dryrun_config(arch, shape, cfg=base, overrides=on)
    with process_group("cpu"):
        mesh = make_custom_mesh("1x1", "cpu")
        step = D.make_step(cfg, shape, mesh)
        args = D.step_args(step, cfg, shape, device="cpu",
                           init=lambda p: registry.init(0, cfg, "cpu"))
        with FlopCounterMode(display=False) as flops:
            step(*args)
    per_call = ssd.ssd_flops(
        (2, SEQ, cfg.ssm_nheads, cfg.ssm_headdim), None, None,
        (2, SEQ, cfg.ssm_state), None, None, min(cfg.ssm_chunk, SEQ))
    assert flops.get_flop_counts()["Global"][torch.ops.smlt.ssd_scan] \
        == cfg.n_layers * per_call
    assert res["flops"] == flops.get_total_flops() > 0


def test_flash_custom_op_opcheck_and_flops():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 256, 32, generator=gen) for _ in range(3))
    for causal, window in ((True, 0), (True, 100), (False, 0)):
        torch.library.opcheck(torch.ops.smlt.flash_attention_fwd.default,
                              (q, k, v, causal, window))
    out = fa.flash_attention(q, k, v)
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(out, fa.plain_flash_attention(q, k, v))
    # causal over T x T tiles runs T(T+1)/2 of them; full runs T^2
    for dtype, tile in ((torch.float32, 64), (torch.bfloat16, 128)):
        x = q.to(dtype)
        t = 256 // tile
        per_tile = 4 * 2 * 3 * 32 * tile * tile
        for causal, want in ((True, t * (t + 1) // 2), (False, t * t)):
            with FlopCounterMode(display=False) as fc:
                fa.flash_attention(x, x, x, causal=causal)
            assert fc.get_total_flops() == per_tile * want
    # a window of one tile: each query tile runs its diagonal tile and the
    # one before it (the first only the diagonal)
    assert fa.flash_tiles_run(256, 256, 64, 64, True, 64) == 1 + 2 * 3
    assert fa.flash_tiles_run(4096, 4096, 128, 128, True, 4096) == 32 * 33 // 2


def test_ssd_custom_op_opcheck_and_flops():
    gen = torch.Generator().manual_seed(0)
    b, s, h, p, n, q = 2, 64, 4, 16, 8, 16
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.rand(b, s, h, generator=gen)
    A, D_ = -torch.rand(h, generator=gen), torch.randn(h, generator=gen)
    B, C = (torch.randn(b, s, n, generator=gen) for _ in range(2))
    torch.library.opcheck(torch.ops.smlt.ssd_scan.default,
                          (x, dt, A, B, C, D_, q, None))
    with FlopCounterMode(display=False) as fc:
        y, S = ssd.ssd_scan(x, dt, A, B, C, D_, chunk=q)
    want_y, want_S = ssd.plain_ssd_scan(x, dt, A, B, C, D_, q)
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(S, want_S)
    per_chunk = 2 * q * q * n + 2 * q * q * p + 2 * q * n * p + 2 * q * n * p
    assert fc.get_total_flops() == b * h * (s // q) * per_chunk


def test_cli_writes_per_pair_json_and_lists_failures(tmp_path, capsys):
    small = ["--set", "n_layers=1", "--set", "d_model=128", "--set",
             "n_heads=4", "--set", "n_kv_heads=4", "--set", "head_dim=32",
             "--set", "d_ff=256", "--set", "vocab_size=997",
             "--mesh-shape", "8x1", "--device", "cpu"]
    D.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--out",
            str(tmp_path), "--tag", "_small"] + small)
    out = capsys.readouterr().out
    assert "dry-run complete" in out
    res = json.loads((tmp_path / "olmo-1b__decode_32k__8x1__hier_small.json")
                     .read_text())
    for key in ("flops", "bytes_accessed", "collectives", "collective_bytes",
                "memory", "params", "active_params", "trace_s"):
        assert key in res
    assert res["overrides"]["head_dim"] == "32"
    with pytest.raises(SystemExit) as e:   # no flash kernel for head dim 48
        D.main(["--arch", "olmo-1b", "--shape", "train_4k"] + small
               + ["--set", "head_dim=48"])
    assert e.value.code == 1
    assert "FAILURES:" in capsys.readouterr().out


def test_train_cli_dry_run_points_at_the_dry_run():
    with pytest.raises(SystemExit, match="repro_torch.launch.dryrun"):
        ttrain.main(["--arch", "olmo-1b", "--dry-run"])
