"""The flash-attention backward of the port (``flash_attention_bwd``, the
kernels of ``csrc/flash_attention_bwd.cu`` and their plain version) and
the forward's logsumexp:

- ``plain_flash_attention_bwd`` against ``jax.vjp`` of the reference's
  differentiable op (``repro.kernels.ops.flash_attention``, Pallas in
  interpret mode) on the same inputs, f32 at rtol 5e-4 / atol 1e-5
  (``tests/test_kernel_integration.py``) and bf16 at 2e-2 / 2e-2
  (``tests/test_kernels.py``), over head dims 32, 64, 112, 128 and windows
  0, 16, 64, 100, and one padded length through the whole op;
- the plain ``lse`` against numpy's logsumexp of the masked, scaled
  scores;
- ``flash_bwd_flops`` against a brute-force count of the tiles each
  backward kernel runs;
- ``smlt::flash_attention_bwd`` and ``smlt::flash_attention_fwd_lse``
  through ``torch.library.opcheck``;
- on meta tensors (the stand-in for CUDA): the launches the wrappers make,
  with the views' strides and (b, s, h, d)-ordered outputs, never the
  plain path;
- the dry run with the flash kernel: the traced FLOPs equal a real CPU
  step's, with the backward op in both."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_custom_mesh, process_group  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.base import InputShape  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=5e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def _pair(a, name):
    """One numpy array as (jax array, torch tensor) of the same dtype and
    bits."""
    jd, td = DTYPES[name]
    x = jnp.array(a, jd)
    if name == "bf16":
        t = torch.from_numpy(np.asarray(x).view(np.uint16).copy())
        return x, t.view(torch.bfloat16)
    return x, torch.from_numpy(np.asarray(x).copy()).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _inputs(seed, shape, name):
    rng = np.random.RandomState(seed)
    return [_pair(rng.randn(*shape), name) for _ in range(4)]


def _jax_grads(jq, jk, jv, jg, window, block=64):
    _, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(
        q, k, v, causal=True, window=window, block_q=block, block_k=block),
        jq, jk, jv)
    return vjp(jg)


@pytest.mark.parametrize("window", [0, 16, 64, 100])
@pytest.mark.parametrize("d", [32, 64, 112, 128])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_plain_bwd_matches_reference_vjp(name, d, window):
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _inputs(d + window,
                                                     (1, 2, 128, d), name)
    want = _jax_grads(jq, jk, jv, jg, window)
    out = fa.plain_flash_attention(tq, tk, tv, causal=True, window=window)
    lse = fa.plain_flash_lse(tq, tk, causal=True, window=window)
    got = fa.plain_flash_attention_bwd(tq, tk, tv, out, lse, tg,
                                       causal=True, window=window)
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype and g.shape == tq.shape
        np.testing.assert_allclose(_np(g), _np(w), **TOL[name])


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_op_grads_on_padded_length_match_reference_vjp(name):
    """Through ops.flash_attention (FlashAttention, the forward's lse, the
    backward wrapper on the CPU): 80 queries padded to 128."""
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _inputs(1, (2, 2, 80, 64), name)
    want = _jax_grads(jq, jk, jv, jg, 24)
    ts = [t.requires_grad_(True) for t in (tq, tk, tv)]
    out = ops.flash_attention(*ts, causal=True, window=24, block_q=64,
                              block_k=64)
    got = torch.autograd.grad(out, ts, tg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL[name])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0), (False, 40)])
def test_plain_lse_matches_numpy_logsumexp(causal, window):
    rng = np.random.RandomState(3)
    q, k = rng.randn(2, 3, 300, 32), rng.randn(2, 3, 300, 32)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float32),
                  k.astype(np.float32)) * 32 ** -0.5
    qi, ki = np.arange(300)[:, None], np.arange(300)[None, :]
    keep = np.ones((300, 300), bool)
    if causal:
        keep &= qi >= ki
    if window:
        keep &= qi - ki < window
    s = np.where(keep, s, -1e30)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    got = fa.plain_flash_lse(torch.from_numpy(q).float(),
                             torch.from_numpy(k).float(), causal=causal,
                             window=window)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    out, lse = fa.flash_attention(torch.from_numpy(q).float(),
                                  torch.from_numpy(k).float(),
                                  torch.from_numpy(k).float(), causal=causal,
                                  window=window, return_lse=True)
    assert torch.equal(lse, got)


def _tiles_brute(sq, sk, bq, bk, causal, window):
    """(query tile, key tile) pairs in which some query sees some key under
    the causal mask, and some under the window: each pair of rows
    checked."""
    n = 0
    for q0 in range(0, sq, bq):
        qs = np.arange(q0, q0 + bq)[:, None]
        for k0 in range(0, sk, bk):
            ks = np.arange(k0, k0 + bk)[None, :]
            run = True
            if causal:
                run &= bool((qs >= ks).any())
            if window:
                run &= bool((qs - ks < window).any())
            n += run
    return n


@pytest.mark.parametrize("sq,sk", [(256, 256), (300, 300), (128, 384),
                                   (4096, 4096)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (True, 100), (True, 4096),
                                           (False, 0), (False, 100)])
def test_bwd_flops_count_the_tiles_each_kernel_runs(sq, sk, causal, window):
    for (bq, bk) in {t for ts in fa.BWD_TILES.values() for t in ts}:
        assert fa.flash_tiles_run(sq, sk, bq, bk, causal, window) \
            == _tiles_brute(sq, sk, bq, bk, causal, window)
    b, h, d = 2, 3, 64
    for dtype, route in ((torch.float32, "cuda_cores"),
                         (torch.bfloat16, "wgmma")):
        q = torch.empty(b, h, sq, d, dtype=dtype, device="meta")
        k = torch.empty(b, h, sk, d, dtype=dtype, device="meta")
        lse = torch.empty(b, h, sq, device="meta")
        (bq1, bk1), (bq2, bk2) = fa.BWD_TILES[route]
        want = 2 * b * h * d * (
            4 * bq1 * bk1 * _tiles_brute(sq, sk, bq1, bk1, causal, window)
            + 3 * bq2 * bk2 * _tiles_brute(sq, sk, bq2, bk2, causal, window))
        assert fa.flash_bwd_flops(q, k, k, q, lse, q, causal, window) == want


def test_bwd_custom_ops_opcheck_and_flops():
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn(2, 3, 256, 32, generator=gen)
                  for _ in range(4))
    for causal, window in ((True, 0), (True, 100), (False, 0)):
        out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                      return_lse=True)
        torch.library.opcheck(torch.ops.smlt.flash_attention_fwd_lse.default,
                              (q, k, v, causal, window))
        torch.library.opcheck(torch.ops.smlt.flash_attention_bwd.default,
                              (q, k, v, out, lse, g, causal, window))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g)
    want = fa.plain_flash_attention_bwd(q, k, v, out, lse, g)
    for a, w in zip(grads, want):
        assert a.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    with FlopCounterMode(display=False) as fc:
        fa.flash_attention_bwd(q, k, v, out, lse, g)
    # causal over 4 x 4 tiles of 64: 10 run, seven products each
    assert fc.get_total_flops() == 2 * 2 * 3 * 32 * 64 * 64 * 7 * 10
    with FlopCounterMode(display=False) as fc:
        fa.flash_attention(q, k, v, return_lse=True)
    assert fc.get_total_flops() == 4 * 2 * 3 * 32 * 64 * 64 * 10


def test_flash_autograd_saves_lse_only_for_a_gradient(monkeypatch):
    """FlashAttention asks for the logsumexp only when an input wants a
    gradient: scoring and prefill run the plain forward entry."""
    seen = []
    real = fa.flash_attention

    def spy(*a, **kw):
        seen.append(kw.get("return_lse", False))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    q = torch.randn(1, 2, 64, 32)
    with torch.no_grad():
        ops.flash_attention(q, q, q)
    qg = q.clone().requires_grad_(True)
    ops.flash_attention(qg, q, q).sum().backward()
    assert seen == [False, True]
    assert qg.grad is not None and qg.grad.shape == q.shape


class _FakeLib:
    """Records the launches a wrapper makes instead of making them."""

    def __init__(self):
        self.calls = []

    def _fwd(self, route, q, k, v, o, lse, b, h, sq, sk, d, causal, window,
             scale, st, stream):
        self.calls.append((f"fwd {route}", lse is not None,
                           (b, h, sq, sk, d), list(st)))
        return 0

    def smlt_flash_attention_fwd_lse(self, q, k, v, o, lse, *args):
        return self._fwd("cuda_cores", q, k, v, o, lse, *args)

    def smlt_flash_attention_fwd_wgmma_lse(self, q, k, v, o, lse, *args):
        return self._fwd("wgmma", q, k, v, o, lse, *args)

    def _bwd(self, route, q, k, v, o, g, lse, dq, dk, dv, lp, dp, b, h, sq,
             sk, d, causal, window, scale, st, stream):
        self.calls.append((f"bwd {route}", (b, h, sq, sk, d, causal, window),
                           list(st)))
        return 0

    def smlt_flash_attention_bwd(self, *args):
        return self._bwd("cuda_cores", *args)

    def smlt_flash_attention_bwd_wgmma(self, *args):
        return self._bwd("wgmma", *args)


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _meta_launches(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(fa, "plain_flash_attention_bwd", _no_plain)
    monkeypatch.setattr(fa, "plain_flash_lse", _no_plain)
    return lib


def _no_plain(*a, **kw):
    raise AssertionError("the plain path was taken on a non-CPU tensor")


@pytest.mark.parametrize("d", [32, 112])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_cores")])
def test_bwd_wrapper_hands_the_kernel_the_views(monkeypatch, dtype, route,
                                                d):
    """Forward with lse and backward through FlashAttention on (b, h, s, d)
    views of (b, s, h, d) meta memory: one launch of each, on the route,
    with every view's (b, h, s) strides; the gradients come back as views
    of (b, s, h, d) memory."""
    lib = _meta_launches(monkeypatch)
    b, s, h = 2, 64, 4
    q, k, v = [torch.empty(b, s, h, d, dtype=dtype, device="meta")
               .transpose(1, 2).requires_grad_(True) for _ in range(3)]
    fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
    by_route = dict(fa.BWD_ROUTE_LAUNCHES)
    out = fa.FlashAttention.apply(q, k, v, True, 16)
    g = torch.empty(b, s, h * d, dtype=dtype, device="meta").reshape(
        b, s, h, d).transpose(1, 2)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    bhsd = [s * h * d, d, h * d]
    assert lib.calls == [
        (f"fwd {route}", True, (b, h, s, s, d), bhsd * 4),
        (f"bwd {route}", (b, h, s, s, d, 1, 16), bhsd * 8)]
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    assert fa.BWD_ROUTE_LAUNCHES[route] == by_route[route] + 1
    for x in (dq, dk, dv):
        assert x.shape == (b, h, s, d) and x.dtype == dtype
        assert x.transpose(1, 2).is_contiguous()


def test_bwd_wrapper_refuses_without_the_kernels(monkeypatch):
    """With the loader failing, a backward on a non-CPU tensor raises and
    counts no launch: it never falls back to the plain version."""
    def no_kernels():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "load", no_kernels)
    monkeypatch.setattr(fa, "plain_flash_attention_bwd", _no_plain)
    q = torch.empty(1, 2, 64, 32, device="meta")
    lse = torch.empty(1, 2, 64, device="meta")
    before = (fa.BWD_LAUNCHES, dict(fa.BWD_ROUTE_LAUNCHES))
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        fa.flash_attention_bwd(q, q, q, q, lse, q)
    assert (fa.BWD_LAUNCHES, fa.BWD_ROUTE_LAUNCHES) == before


def test_bwd_wrapper_refuses_what_it_cannot_read():
    q = torch.empty(1, 2, 64, 32, device="meta")
    lse = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="last dim"):
        fa.flash_attention_bwd(q, q, q, q, lse, q.transpose(2, 3)
                               .contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd(q, q, q, q, lse.transpose(1, 2).contiguous()
                               .transpose(1, 2), q)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention_bwd(q, q, q, q, lse.half(), q)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_bwd(q, q, q, q.half(), lse, q)
    with pytest.raises(ValueError, match="16 bytes"):
        x = torch.empty(1, 2, 64, 36, dtype=torch.bfloat16,
                        device="meta")[..., :32]
        fa.flash_attention_bwd(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                               q.bfloat16(), lse, x)


def test_dryrun_flops_equal_real_step_with_the_backward_op():
    """The dry run's trace of reduced olmo-1b's ZeRO-3 train step (remat,
    the flash kernel) equals the same step run on real CPU tensors in
    FLOPs, and both count the backward op once a layer."""
    shape = InputShape("train_2x64", 64, 2, "train")
    base = reduced(ARCHS["olmo-1b"])
    res = D.lower_one("olmo-1b", shape, multi_pod=False, mesh_shape="1x1",
                      device="cpu", cfg=base)
    cfg = D.dryrun_config("olmo-1b", shape, cfg=base)
    assert cfg.use_flash_kernel and cfg.remat
    with process_group("cpu"):
        mesh = make_custom_mesh("1x1", "cpu")
        step = D.make_step(cfg, shape, mesh)
        args = D.step_args(step, cfg, shape, device="cpu",
                           init=lambda p: registry.init(0, cfg, "cpu"))
        fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
        with FlopCounterMode(display=False) as flops:
            step(*args)
    counts = flops.get_flop_counts()["Global"]
    bwd_op = torch.ops.smlt.flash_attention_bwd
    assert counts[bwd_op] > 0
    assert res["flops"] == flops.get_total_flops()
    # the formula of the CPU's f32 route: remat runs each forward twice
    b, h, s, d = 2, cfg.n_heads, 64, cfg.resolved_head_dim
    lse = torch.empty(b, h, s, device="meta")
    q = torch.empty(b, h, s, d, device="meta")
    assert counts[bwd_op] == cfg.n_layers * fa.flash_bwd_flops(
        q, q, q, q, lse, q, True, cfg.sliding_window)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (fwd, bwd)  # CPU: no launch
