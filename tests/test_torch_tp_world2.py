"""Tensor parallelism over the ``model`` axis (ROADMAP A16b) and the
masked-label step loss (ROADMAP C1) on 2 gloo ranks
(``tests/torch_dist_checks.py`` suite ``tp2``, one spawn for the file
under a hard deadline), each rank on its model parts of the reference's
init(key 0) of a reduced config:

- each ``TP_MESHES["1x2"]`` case: its rows' logits (rtol 1e-4 / atol
  5e-5), the loss (rtol 1e-5) and every gradient gathered back to the
  whole leaf (rtol 5e-4 / atol 1e-5) against the reference's on one
  device (``tests/torch_tp_ref.py``): dense olmo-1b, qwen2.5-3b and
  phi4-mini (one KV head, split inside it), qwen2-moe (4 experts, expert
  parallel), mamba2 (heads split, the gated norm summed over the group);
- the prefill and serve steps on "1x2" against the same calls at world
  size 1: the last position's logits of prefill and of 3 teacher-forced
  decode steps (rtol 1e-4 / atol 5e-5), the caches gathered back (qwen2.5
  splits its one KV head's dims: the decode contracts them with an
  all-reduce), and of qwen2.5 without the rotary embedding (``nope``,
  an option of the port alone);
- C1: one step of ``hier``, ``hier1`` and ``allreduce``, ZeRO-3 off and
  on, on (data 2) with rows 0-1 masked from position 2 on: the loss equals
  the reference's global-batch loss, 7.416166, at the curve's rtol 1e-4,
  and the first moments its (rtol 5e-4, atol 1e-5 of each leaf's largest);
- the dry run: rank 0's FLOPs traced on a fake "1x2" mesh equal a real
  gloo rank's; each family of the slice traced on fake "1x2", "2x2" and
  "1x4" meshes with finite terms, its train FLOPs falling with the model
  axis; the hybrid, vlm and audio families traced by the CLI on "1x2",
  with no skipped row in ``tools/dryrun_table.py``'s table."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as dc  # noqa: E402
import torch_tp_ref as ref  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.launch.steps import make_train_step as j_make_step  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.base import InputShape  # noqa: E402

CURVE_RTOL = 1e-4             # tests/test_torch_train.py's
C1_LOSS = 7.416166            # ROADMAP C1's expected value
FAMILIES = ["olmo-1b", "qwen2-moe-a2.7b", "mamba2-2.7b"]
KINDS = ["train", "prefill", "decode"]


@pytest.fixture(autouse=True)
def _split_reduced_leaves(monkeypatch):
    monkeypatch.setattr(steps, "FSDP_MIN_SIZE", dc.FSDP_MIN_SIZE)


@pytest.fixture(scope="module")
def c1_ref():
    """The reference's one step on the masked batch: its loss and first
    moments (one device; its strategies compute the same step)."""
    cfg = j_reduced(J_ARCHS["olmo-1b"])
    step, pshard, oshard, _ = j_make_step(cfg, jtrain.make_local_mesh(),
                                          strategy="hier",
                                          optimizer=JAdamW(lr=3e-4))
    params = jax.device_put(jreg.init(jax.random.key(0), cfg), pshard)
    opt = JAdamW(lr=3e-4)
    state = jax.device_put(opt.init(params), oshard)
    batch = {k: jnp.asarray(v) for k, v in
             dc.masked_batch(cfg.vocab_size).items()}
    _, state, loss = step(params, state, batch)
    return {"loss": float(loss),
            "mu": dict(T.leaves_with_path(jax.tree.map(np.asarray,
                                                       state.mu)))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tp2"))
    ref.write_inits(work, sorted(set(dc.TP_MESHES["1x2"])
                                 | set(dc.TP_STEP_CASES)))
    dc.run_world("tp2", 2, work, timeout=400)
    return [dc.load(work, f"tp2_rank{r}") for r in range(2)]


@pytest.mark.parametrize("case", dc.TP_MESHES["1x2"])
def test_model2_matches_reference(ranks, case):
    for r in ranks:
        ref.check_case(r, f"1x2/{case}", case)


@pytest.mark.parametrize("case", dc.TP_STEP_CASES)
def test_prefill_and_serve_steps_model2_equal_world1(ranks, case):
    key = f"steps/{case}"
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/got"], r[f"{key}/want"],
                                   rtol=ref.LOGITS_RTOL,
                                   atol=ref.LOGITS_ATOL)
        pre = f"{key}/cache/"
        for k in (k for k in r if k.startswith(pre)):
            np.testing.assert_allclose(
                r[k], r[f"{key}/want_cache/{k[len(pre):]}"],
                rtol=ref.LOGITS_RTOL, atol=ref.LOGITS_ATOL, err_msg=k)
    if case == "qwen2.5-3b":          # one KV head of 32: its dims split
        assert "(2, 4, 32, 1, 16)" in str(ranks[0][f"{key}/cache_shapes"])


@pytest.mark.parametrize("fsdp", ["replicated", "fsdp"])
@pytest.mark.parametrize("strategy", ["hier", "hier1", "allreduce"])
def test_masked_labels_weight_each_token(ranks, c1_ref, strategy, fsdp):
    """ROADMAP C1: each rank's loss divides by the mean count of labels
    >= 0 over the data group, so the step's loss and gradient are the
    global batch's (the parent step gave 7.634789)."""
    assert c1_ref["loss"] == pytest.approx(C1_LOSS, rel=1e-6)
    key = f"c1/{strategy}/{fsdp}"
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{key}/loss"]), c1_ref["loss"],
                                   rtol=CURVE_RTOL)
        pre = f"{key}/mu/"
        got = {k[len(pre):]: v for k, v in r.items() if k.startswith(pre)}
        assert sorted(got) == sorted(c1_ref["mu"])
        for path, mu in got.items():
            w = c1_ref["mu"][path]
            np.testing.assert_allclose(mu, w, rtol=5e-4,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{key} mu {path}")


def _train_shape(batch):
    return InputShape("train_small", dc.TP_SEQ, batch, "train")


@pytest.mark.parametrize("arch", dc.TP_DRYRUN_ARCHS)
def test_dryrun_world2_flops_equal_real_rank(ranks, arch):
    res = D.lower_one(arch, _train_shape(dc.TP_DRYRUN_BATCH),
                      multi_pod=False, mesh_shape="1x2", device="cpu",
                      cfg=reduced(ARCHS[arch]))
    for r in ranks:
        assert res["flops"] == float(r[f"dryrun/{arch}/flops"]) > 0


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_dryrun_model_axis_terms(arch, kind, mesh):
    """A fake model-axis mesh: every term finite and positive, the
    model-group collectives recorded; a train step's per-rank FLOPs below
    those of the same data split without a model axis."""
    shape = InputShape(f"{kind}_small", dc.TP_SEQ, 8, kind)
    cfg = reduced(ARCHS[arch])
    res = D.lower_one(arch, shape, multi_pod=False, mesh_shape=mesh,
                      device="cpu", cfg=cfg)
    mem = res["memory"]
    terms = [res["flops"], res["bytes_accessed"], res["collective_bytes"],
             mem["argument_size_in_bytes"], mem["peak_memory_in_bytes"]]
    assert np.isfinite(terms).all() and min(terms) > 0, res
    assert res["collectives"]["all-reduce"]["count"] > 0
    if kind == "train":
        data = mesh.split("x")[0]
        whole = D.lower_one(arch, shape, multi_pod=False,
                            mesh_shape=f"{data}x1", device="cpu", cfg=cfg)
        assert res["flops"] < whole["flops"]


# a depth of one shared-block group, one cross group, two layers each
DEPTH = {"olmo-1b": ["n_layers=2"], "zamba2-7b": ["n_layers=6"],
         "llama-3.2-vision-90b": ["n_layers=5"],
         "seamless-m4t-medium": ["n_layers=2", "n_encoder_layers=2"]}


def _sets(arch):
    return [x for kv in DEPTH[arch] for x in ("--set", kv)]


def test_dryrun_skips_families_outside_the_slice(capsys):
    """The CLI on a model axis traces the hybrid, vlm and audio pairs
    (once skipped, before their layers took a model axis): none is
    skipped or fails."""
    for arch in ("zamba2-7b", "llama-3.2-vision-90b",
                 "seamless-m4t-medium"):
        D.main(["--arch", arch, "--shape", "decode_32k", "--mesh-shape",
                "1x2", "--device", "cpu"] + _sets(arch))
        out = capsys.readouterr().out
        assert f"=== {arch}__decode_32k__1x2" in out and "SKIP" not in out
        assert "dry-run complete: every combination traced" in out


def test_dryrun_table_model_axis_rows(tmp_path, capsys):
    """``tools/dryrun_table.py``'s table on a model-axis mesh: each pair's
    per-rank terms, the hybrid's too, none skipped."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import dryrun_table
    out = str(tmp_path)
    for arch in ("olmo-1b", "zamba2-7b"):
        D.main(["--arch", arch, "--shape", "decode_32k", "--mesh-shape",
                "1x2", "--device", "cpu", "--out", out] + _sets(arch))
    capsys.readouterr()
    rows = dryrun_table.table(out, ("1x2",)).splitlines()
    for arch in ("olmo-1b", "zamba2-7b"):
        row = next(r for r in rows if r.startswith(f"| {arch} | decode_32k"))
        assert "skipped" not in row
        assert float(row.split("|")[3]) >= 0      # TFLOP
