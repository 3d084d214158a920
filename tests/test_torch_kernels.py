"""The port's kernel entry points (``repro_torch.kernels``) against the
reference's (``repro.kernels.ops`` in Pallas interpret mode, and
``repro.kernels.ref``) over the sweeps of ``tests/test_kernels.py``, at its
tolerances (the SSD scan's: f32 2e-4 on y and the state; bf16 5e-2 on y,
1e-2 on the state). On the CPU each wrapper runs its plain version; a tensor on any
other device must reach the kernel or raise."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, hier_agg, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

RNG = np.random.RandomState(0)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
        else dict(rtol=2e-4, atol=2e-5)


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


# ---------------------------------------------------------------------------
# shard aggregation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_workers", [1, 2, 8, 17])
@pytest.mark.parametrize("length", [128, 1000, 8192, 20000])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_aggregate_shards_matches_reference(n_workers, length, dtype):
    jx, tx = _pair(RNG.randn(n_workers, length), dtype)
    got = ops.aggregate_shards(tx, block=1024)
    assert got.dtype == tx.dtype and got.shape == (length,)
    np.testing.assert_allclose(_np(got), _np(jops.aggregate_shards(jx, block=1024)),
                               **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(jref.ref_aggregate(jx)),
                               **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(ref.ref_aggregate(tx)),
                               **_tol(dtype))


def test_aggregate_plain_sums_in_worker_order():
    """The plain version is the reference kernel's arithmetic: f32 sum in
    worker order, then / n — bit for bit on f32."""
    x = RNG.randn(5, 777).astype(np.float32)
    want = x[0].copy()
    for w in range(1, 5):
        want = want + x[w]
    want = want / np.float32(5)
    got = hier_agg.plain_aggregate_shards(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("length", [512, 5000])
def test_aggregate_and_apply_matches_reference(length):
    x = RNG.randn(4, length).astype(np.float32)
    p = RNG.randn(length).astype(np.float32)
    got = ops.aggregate_and_apply(torch.from_numpy(x), torch.from_numpy(p),
                                  lr=0.05, block=512)
    want = jref.ref_aggregate_apply(jnp.array(x), jnp.array(p), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), ref.ref_aggregate_apply(torch.from_numpy(x),
                                             torch.from_numpy(p), 0.05).numpy(),
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,block", [(128, 64), (160, 64), (256, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_causal_matches_reference(seq, block, dtype):
    b, h, d = 2, 3, 64
    (jq, tq), (jk, tk), (jv, tv) = [_pair(RNG.randn(b, h, seq, d), dtype)
                                    for _ in range(3)]
    got = ops.flash_attention(tq, tk, tv, causal=True, block_q=block,
                              block_k=block)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    want = jops.flash_attention(jq, jk, jv, causal=True, block_q=block,
                                block_k=block)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(jref.ref_attention(jq, jk, jv)),
                               **_tol(dtype))


@pytest.mark.parametrize("window", [16, 64, 100])
def test_flash_sliding_window_matches_reference(window):
    b, h, seq, d = 1, 2, 192, 32
    (jq, tq), (jk, tk), (jv, tv) = [_pair(RNG.randn(b, h, seq, d), "f32")
                                    for _ in range(3)]
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              block_q=64, block_k=64)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        _np(got), _np(ref.ref_attention(tq, tk, tv, causal=True,
                                        window=window)),
        rtol=2e-4, atol=2e-5)


def test_flash_matches_model_blockwise():
    from repro_torch.models.layers import blockwise_attention
    b, h, seq, d = 2, 2, 128, 32
    q, k, v = [torch.from_numpy(RNG.randn(b, h, seq, d).astype(np.float32))
               for _ in range(3)]
    got = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    want = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_flash_grads_match_reference_vjp():
    """Backward = gradient of the blockwise attention, as the reference's
    custom_vjp (padded sequence included)."""
    import jax
    b, h, seq, d = 1, 2, 80, 32
    arrs = [RNG.randn(b, h, seq, d).astype(np.float32) for _ in range(3)]
    g = RNG.randn(b, h, seq, d).astype(np.float32)
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jops.flash_attention(
        q, k, v, causal=True, window=24, block_q=64, block_k=64) * g),
        argnums=(0, 1, 2))(*map(jnp.array, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = ops.flash_attention(*ts, causal=True, window=24, block_q=64,
                              block_k=64)
    tgrads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for a, t in zip(jgrads, tgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=5e-4,
                                   atol=1e-5)


def test_flash_noncausal_padded_kv_raises():
    q = torch.zeros(1, 1, 20, 32)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, q, q, causal=False, block_q=16, block_k=16)


@pytest.mark.parametrize("d", [32, 64, 112, 128])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_cores")])
def test_flash_route_by_dtype(d, dtype, route):
    """bf16 goes to the tensor cores, f32 to the CUDA cores (TF32 could not
    hold the f32 tolerance), whatever the head dim."""
    assert fa.flash_route(dtype, d) == route


def test_flash_route_refuses_other_dtypes_and_dims():
    with pytest.raises(TypeError, match="f32 or bf16"):
        fa.flash_route(torch.float16, 64)
    for d in (48, 96, 120, 256):
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_route(torch.bfloat16, d)


def test_flash_takes_every_head_dim_of_the_configs():
    """Every arch's head dim, full width and reduced, has a route on
    both dtypes (zamba2-7b's is 112)."""
    from repro_torch.configs import ARCHS, reduced
    dims = {c.resolved_head_dim for a in ARCHS.values() if a.n_heads
            for c in (a, reduced(a))}
    assert dims == {32, 64, 112, 128}
    for d in dims:
        for dtype in (torch.float32, torch.bfloat16):
            fa.flash_route(dtype, d)


@pytest.mark.parametrize("d", [32, 64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_strides_take_the_models_views(d, dtype):
    """The model's q.transpose(1, 2) of (b, s, h, d) memory is read in
    place: the kernel gets its (b, h, s) strides."""
    b, s, h = 2, 48, 3
    x = torch.empty(b, s, h, d, dtype=dtype, device="meta").transpose(1, 2)
    route = fa.flash_route(dtype, d)
    assert fa.kernel_strides(x, route) == [s * h * d, d, h * d]


@pytest.mark.parametrize("route", ["wgmma", "cuda_cores"])
def test_kernel_strides_refuse_a_strided_last_dim(route):
    x = torch.empty(1, 2, 64, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="last dim"):
        fa.kernel_strides(x.transpose(2, 3), route)


def test_kernel_strides_tma_alignment():
    """Rows of 36 bf16 are 72 bytes: TMA cannot stride them, the CUDA cores
    can. A size-1 dim's stride never counts."""
    x = torch.empty(1, 2, 64, 36, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="16 bytes"):
        fa.kernel_strides(x[..., :32], "wgmma")
    assert fa.kernel_strides(x[..., :32], "cuda_cores") == [
        2 * 64 * 36, 64 * 36, 36]
    one = torch.empty(1, 1, 5, 32, dtype=torch.bfloat16, device="meta")
    assert all(st % 8 == 0 for st in fa.kernel_strides(one, "wgmma"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 24])
def test_flash_on_transposed_views_matches_reference(dtype, window):
    """ops.flash_attention on (b, s, h, d) memory seen as (b, h, s, d)
    views, as the model calls it, against the reference on the same
    numpy inputs."""
    b, s, h, d = 2, 128, 3, 64
    pairs = [_pair(RNG.randn(b, s, h, d), dtype) for _ in range(3)]
    jq, jk, jv = [jnp.transpose(j, (0, 2, 1, 3)) for j, _ in pairs]
    tq, tk, tv = [t.transpose(1, 2) for _, t in pairs]
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              block_q=64, block_k=64)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                block_q=64, block_k=64)
    assert got.shape == (b, h, s, d)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seq,window", [(128, 0), (160, 24), (256, 64)])
def test_flash_head_dim_112_matches_reference(dtype, seq, window):
    """zamba2-7b's head dim on the model's (b, s, h, d) views, causal and
    windowed, against the reference's Pallas kernel in interpret mode."""
    b, h, d = 1, 2, 112
    pairs = [_pair(RNG.randn(b, seq, h, d), dtype) for _ in range(3)]
    jq, jk, jv = [jnp.transpose(j, (0, 2, 1, 3)) for j, _ in pairs]
    tq, tk, tv = [t.transpose(1, 2) for _, t in pairs]
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              block_q=64, block_k=64)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                block_q=64, block_k=64)
    assert got.shape == (b, h, seq, d)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


class _FakeLib:
    """Records the kernel calls the wrapper makes (no card here)."""

    def __init__(self):
        self.calls = []

    def smlt_flash_attention_fwd_wgmma(self, q, k, v, o, b, h, sq, sk, d,
                                       causal, window, scale, st, stream):
        self.calls.append(("wgmma", (b, h, sq, sk, d), list(st)))
        return 0

    def smlt_flash_attention_fwd(self, q, k, v, o, b, h, sq, sk, d, causal,
                                 window, scale, st, stream):
        self.calls.append(("cuda_cores", (b, h, sq, sk, d), list(st)))
        return 0


@pytest.mark.parametrize("d", [32, 112])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_cores")])
def test_flash_wrapper_hands_the_kernel_the_views(monkeypatch, dtype, route,
                                                  d):
    """On a non-CPU tensor (meta stands in for CUDA) the wrapper calls the
    route's kernel with the views' own strides, counts one launch on
    LAUNCHES and on its route, and returns a (b, h, s, d) view of
    (b, s, h, d) memory."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    b, s, h = 2, 64, 4
    q, k, v = [torch.empty(b, s, h, d, dtype=dtype, device="meta")
               .transpose(1, 2) for _ in range(3)]
    before, by_route = fa.LAUNCHES, dict(fa.ROUTE_LAUNCHES)
    out = fa.flash_attention(q, k, v)
    assert lib.calls == [(route, (b, h, s, s, d), [s * h * d, d, h * d] * 4)]
    assert fa.LAUNCHES == before + 1
    assert fa.ROUTE_LAUNCHES[route] == by_route[route] + 1
    assert out.shape == (b, h, s, d) and out.transpose(1, 2).is_contiguous()


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------


def _ssd_inputs(b, s, h, p, n, name="f32"):
    """tests/test_kernels.py's inputs: x, dt, B, C in the swept dtype; A
    and D in f32. Returns (jax arrays, torch tensors)."""
    arrs = (RNG.randn(b, s, h, p), np.abs(RNG.randn(b, s, h)) * 0.5 + 0.01,
            -(np.abs(RNG.randn(h)) + 0.5), RNG.randn(b, s, n),
            RNG.randn(b, s, n), RNG.randn(h))
    names = (name, name, "f32", name, name, "f32")
    pairs = [_pair(a, nm) for a, nm in zip(arrs, names)]
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 32), (256, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_scan_matches_reference(s, chunk, dtype):
    jargs, targs = _ssd_inputs(2, s, 4, 16, 8, dtype)
    y, S = ops.ssd_scan(*targs, chunk=chunk)
    assert y.dtype == targs[0].dtype and y.shape == targs[0].shape
    assert S.dtype == torch.float32 and S.shape == (2, 4, 8, 16)
    jy, jS = jops.ssd_scan(*jargs, chunk=chunk)
    ry, rS = jref.ref_ssd(*jargs)
    ty, tS = ref.ref_ssd(*targs)
    ytol = dict(rtol=5e-2, atol=5e-2) if dtype == "bf16" \
        else dict(rtol=2e-4, atol=2e-4)
    stol = dict(rtol=1e-2, atol=1e-2) if dtype == "bf16" \
        else dict(rtol=2e-4, atol=2e-4)
    for want_y, want_S in ((jy, jS), (ry, rS), (ty, tS)):
        np.testing.assert_allclose(_np(y), _np(want_y), **ytol)
        np.testing.assert_allclose(_np(S), _np(want_S), **stol)


def test_ssd_plain_matches_model_chunked():
    from repro_torch.models.mamba2 import ssd_chunked
    _, targs = _ssd_inputs(1, 96, 2, 8, 4)
    y, S = ops.ssd_scan(*targs, chunk=32)
    y2, S2 = ssd_chunked(*targs, 32)
    np.testing.assert_allclose(y.numpy(), y2.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(S.numpy(), S2.numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_scan_takes_the_model_path_dtypes():
    """x, B, C bf16; dt, A f32; D a bf16 parameter: the mix the model hands
    the kernel, against the reference's Pallas kernel on the same mix."""
    b, s, h, p, n = 2, 64, 4, 16, 8
    x, B, C = (_pair(RNG.randn(*shape), "bf16")
               for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = _pair(np.abs(RNG.randn(b, s, h)) * 0.5 + 0.01, "f32")
    A = _pair(-(np.abs(RNG.randn(h)) + 0.5), "f32")
    D = _pair(RNG.randn(h), "bf16")
    jargs, targs = zip(*(x, dt, A, B, C, D))
    y, S = ops.ssd_scan(*targs, chunk=16)
    jy, jS = jops.ssd_scan(*jargs, chunk=16)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_np(S), _np(jS), rtol=1e-2, atol=1e-2)


def test_ssd_scan_pads_to_the_chunk_and_keeps_the_state():
    """s = 40 with chunk 16 pads to 48; padded dt = 0 leaves the state as
    the unpadded recurrence leaves it."""
    _, targs = _ssd_inputs(1, 40, 2, 8, 4)
    y, S = ops.ssd_scan(*targs, chunk=16)
    ry, rS = ref.ref_ssd(*targs)
    assert y.shape == targs[0].shape
    np.testing.assert_allclose(y.numpy(), ry.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(S.numpy(), rS.numpy(), rtol=2e-4, atol=2e-4)


def _slow_decay_inputs(b, s, h, p, n, name):
    """Mamba2's initial ranges: dt log-uniform in [1e-3, 1e-1], A = -U[1, 16]
    (tests/test_kernels.py's dt A ~ -0.5 a token forgets the state within a
    chunk; these carry it across chunks)."""
    arrs = (RNG.randn(b, s, h, p),
            np.exp(RNG.uniform(np.log(1e-3), np.log(1e-1), (b, s, h))),
            -RNG.uniform(1.0, 16.0, h), RNG.randn(b, s, n),
            RNG.randn(b, s, n), RNG.randn(h))
    names = (name, "f32", "f32", name, name, "f32")
    pairs = [_pair(a, nm) for a, nm in zip(arrs, names)]
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,chunk,p,n", [(256, 64, 16, 8), (1024, 256, 64, 128)])
def test_ssd_slow_decay_matches_reference(dtype, s, chunk, p, n):
    """A state that lives across four chunks: the port against the
    reference's Pallas kernel at its tolerances."""
    jargs, targs = _slow_decay_inputs(1, s, 2, p, n, dtype)
    y, S = ops.ssd_scan(*targs, chunk=chunk)
    jy, jS = jops.ssd_scan(*jargs, chunk=chunk)
    assert float(np.abs(_np(jS)).max()) > 0.1
    ytol = dict(rtol=5e-2, atol=5e-2) if dtype == "bf16" \
        else dict(rtol=2e-4, atol=2e-4)
    stol = dict(rtol=1e-2, atol=1e-2) if dtype == "bf16" \
        else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(y), _np(jy), **ytol)
    np.testing.assert_allclose(_np(S), _np(jS), **stol)


@pytest.mark.parametrize("dtype,p,n,chunk,route", [
    (torch.bfloat16, 64, 128, 256, "wgmma"),     # mamba2-2.7b
    (torch.bfloat16, 64, 64, 256, "wgmma"),      # zamba2-7b
    (torch.bfloat16, 16, 16, 64, "wgmma"),
    (torch.bfloat16, 16, 8, 16, "cuda_cores"),   # the reference's sweep
    (torch.bfloat16, 16, 8, 64, "cuda_cores"),
    (torch.bfloat16, 64, 128, 32, "cuda_cores"),
    (torch.bfloat16, 64, 256, 256, "cuda_cores"),
    (torch.bfloat16, 48, 128, 512, "cuda_cores"),
    (torch.float32, 64, 128, 256, "cuda_cores"),  # TF32 cannot hold 2e-4
])
def test_ssd_route(dtype, p, n, chunk, route):
    assert ssd.ssd_route(dtype, p, n, chunk) == route


def test_ssd_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="f32 or bf16"):
        ssd.ssd_route(torch.float16, 64, 128, 256)


def test_kernel_strides_take_the_ssd_views():
    """The SSD scan's x (b, s, h, p) in place; B and C the halves of one
    (b, s, 2n) tensor (C's base 256 bytes in); a row of 130 bf16 (260
    bytes) cannot be read through TMA."""
    b, s, h, p, n = 2, 64, 80, 64, 128
    x = torch.empty(b, s, h, p, dtype=torch.bfloat16, device="meta")
    assert fa.kernel_strides(x, "wgmma") == [s * h * p, h * p, p]
    B, C = torch.split(torch.empty(b, s, 2 * n, dtype=torch.bfloat16,
                                   device="meta"), n, dim=-1)
    assert fa.kernel_strides(B, "wgmma") == [s * 2 * n, 2 * n]
    assert fa.kernel_strides(C, "wgmma") == [s * 2 * n, 2 * n]
    wide = torch.empty(b, s, 130, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="16 bytes"):
        fa.kernel_strides(wide[..., :128], "wgmma")


class _FakeSSDLib:
    """Records the SSD kernel calls the wrapper makes (no card here)."""

    def __init__(self):
        self.calls = []

    def smlt_ssd_scan_wgmma(self, x, dt, A, B, C, D, y, fs, b, s, h, p, n,
                            chunk, st, stream):
        self.calls.append(("wgmma", (b, s, h, p, n, chunk), list(st)))
        return 0

    def smlt_ssd_scan(self, x, dt, A, B, C, D, y, fs, b, s, h, p, n, chunk,
                      sbb, sbt, scb, sct, dtype, stream):
        self.calls.append(("cuda_cores", (b, s, h, p, n, chunk),
                           [sbb, sbt, scb, sct]))
        return 0


def _fake_ssd(monkeypatch):
    lib = _FakeSSDLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    return lib


def _meta_ssd_args(b, s, h, p, n, dtype):
    x = torch.empty(b, s, h, p, dtype=dtype, device="meta")
    dt = torch.empty(b, s, h, device="meta")
    hv = torch.empty(h, device="meta")
    B, C = torch.split(torch.empty(b, s, 2 * n, dtype=dtype, device="meta"),
                       n, dim=-1)
    return x, dt, hv, B, C, hv


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_cores")])
def test_ssd_wrapper_hands_the_kernel_the_views(monkeypatch, dtype, route):
    """On a non-CPU tensor (meta stands in for CUDA) the wrapper calls the
    route's kernel with the model's views in place (B and C the halves of
    one (b, s, 2n) tensor) and counts one launch on LAUNCHES and its
    route."""
    lib = _fake_ssd(monkeypatch)
    b, s, h, p, n = 2, 512, 4, 64, 128
    before, by_route = ssd.LAUNCHES, dict(ssd.ROUTE_LAUNCHES)
    y, S = ssd.ssd_scan(*_meta_ssd_args(b, s, h, p, n, dtype), chunk=256)
    want = ([s * h * p, h * p, p] + [s * 2 * n, 2 * n] * 2
            if route == "wgmma" else [s * 2 * n, 2 * n] * 2)
    assert lib.calls == [(route, (b, s, h, p, n, 256), want)]
    assert ssd.LAUNCHES == before + 1
    assert ssd.ROUTE_LAUNCHES[route] == by_route[route] + 1
    assert y.shape == (b, s, h, p) and y.dtype == dtype
    assert S.shape == (b, h, n, p) and S.dtype == torch.float32


def test_ssd_route_keyword(monkeypatch):
    """route= picks PR 12's kernel for a bf16 shape the tensor cores take;
    it never falls back: naming the tensor cores for a shape they do not
    take raises, as does an unknown route."""
    lib = _fake_ssd(monkeypatch)
    args = _meta_ssd_args(1, 256, 2, 64, 128, torch.bfloat16)
    ssd.ssd_scan(*args, chunk=256, route="cuda_cores")
    assert [c[0] for c in lib.calls] == ["cuda_cores"]
    with pytest.raises(ValueError, match="wgmma route"):
        ssd.ssd_scan(*args, chunk=32, route="wgmma")
    with pytest.raises(ValueError, match="route"):
        ssd.ssd_scan(*args, chunk=256, route="tensor")
    assert len(lib.calls) == 1


def test_build_hashes_every_source_and_header(tmp_path, monkeypatch):
    """Every header a source includes is in _build.HEADERS, and an edit to
    it names another library, so the next load() rebuilds."""
    import re
    import shutil
    included = set()
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        included |= set(re.findall(r'#include "([^"]+)"', text))
    assert included == set(_build.HEADERS)
    for name in _build.SOURCES + _build.HEADERS:
        shutil.copy(_build.CSRC / name, tmp_path / name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != before


# ---------------------------------------------------------------------------
# dispatch: only a CPU tensor takes the plain version
# ---------------------------------------------------------------------------


def _no_kernels():
    raise RuntimeError("kernel library unavailable")


@pytest.mark.parametrize("call", [
    lambda x: ops.aggregate_shards(x),
    lambda x: hier_agg.aggregate_shards(x),
    lambda x: ops.flash_attention(x.reshape(1, 2, 64, 32),
                                  x.reshape(1, 2, 64, 32),
                                  x.reshape(1, 2, 64, 32)),
    lambda x: fa.flash_attention(x.reshape(1, 2, 64, 32),
                                 x.reshape(1, 2, 64, 32),
                                 x.reshape(1, 2, 64, 32)),
    lambda x: ops.aggregate_and_apply(x, x[0], lr=0.1),
    lambda x: hier_agg.aggregate_and_apply(x, x[0], 0.1),
    lambda x: ops.ssd_scan(x.reshape(1, 64, 2, 32), x[0, :128].reshape(1, 64, 2),
                           x[0, :2], x[:, :512].reshape(1, 64, 16),
                           x[:, :512].reshape(1, 64, 16), x[0, :2], chunk=32),
])
def test_non_cpu_tensor_never_takes_plain_path(monkeypatch, call):
    """With the loader failing, a kernel request on a non-CPU tensor (the
    meta device stands in for CUDA here) raises instead of returning the
    plain result, and counts no launch."""
    monkeypatch.setattr(_build, "load", _no_kernels)
    before = _launches()
    x = torch.empty(2, 2048, device="meta")
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        call(x)
    assert _launches() == before


def _launches():
    return (hier_agg.LAUNCHES, hier_agg.APPLY_LAUNCHES, fa.LAUNCHES,
            dict(fa.ROUTE_LAUNCHES), ssd.LAUNCHES, dict(ssd.ROUTE_LAUNCHES))


def test_cpu_calls_count_no_launch():
    before = _launches()
    x = torch.randn(3, 256)
    ops.aggregate_shards(x)
    ops.aggregate_and_apply(x, x[0], lr=0.1)
    q = torch.randn(1, 1, 32, 32)
    ops.flash_attention(q, q, q)
    _, targs = _ssd_inputs(1, 32, 2, 8, 4)
    ops.ssd_scan(*targs, chunk=16)
    assert _launches() == before


def test_aggregate_and_apply_has_no_cuda_path_yet():
    """The CUDA path exists now (ROADMAP B2 done); on a non-CPU tensor the
    wrapper refuses what its kernel does not take before loading it."""
    x = torch.empty(4, 512, device="meta")
    with pytest.raises(TypeError, match="f32 or bf16"):
        hier_agg.aggregate_and_apply(x.half(), x[0].half(), 0.1)
    with pytest.raises(TypeError, match="one dtype"):
        hier_agg.aggregate_and_apply(x, x[0].bfloat16(), 0.1)
    with pytest.raises(ValueError, match="param"):
        hier_agg.aggregate_and_apply(x, x[0, :500], 0.1)
