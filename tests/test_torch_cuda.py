"""Card-only checks of the hand-written CUDA kernels: each is held against
its plain version on the card, counts its launches, and refuses what it
does not take; and of the serving engine's decode step replayed as a
captured CUDA graph, against its eager loop. Marked ``cuda``; they skip
on a machine without a card and run there with ``python -m pytest -q -m
cuda tests/test_torch_cuda.py``."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import adamw as adamw_k  # noqa: E402
from repro_torch.kernels import hier_agg, ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


# ||got - want|| / ||want|| of the bf16 route against its plain version,
# about twice what it measures (2.0e-3 to 2.3e-3, P rounded to bf16); the
# elementwise 2e-2 alone admits an error confined to the late rows
BF16_REL_NORM = 5e-3
# the same for the tensor-core SSD route's y, about twice what its split-
# bf16 arithmetic gives, emulated (tests/test_torch_ssd_numerics.py)
SSD_BF16_REL_NORM = 2.5e-4


def _rel_norm_err(got, want):
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("n", [1, 3, 17])
@pytest.mark.parametrize("length", [1, 127, 4096, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aggregate_kernel_bit_equal_to_plain(gen, n, length, dtype):
    x = _randn(gen, n, length, dtype=dtype)
    before = hier_agg.LAUNCHES
    got = hier_agg.aggregate_shards(x)
    assert hier_agg.LAUNCHES == before + 1
    assert torch.equal(got, hier_agg.plain_aggregate_shards(x))


def test_aggregate_kernel_on_unaligned_view(gen):
    x = _randn(gen, 4, 1001)[:, 1:]            # rows not 16-byte aligned
    assert torch.equal(hier_agg.aggregate_shards(x),
                       hier_agg.plain_aggregate_shards(x))


@pytest.mark.parametrize("d", [32, 64, 112, 128])
@pytest.mark.parametrize("which", ["qk", "pv"])
def test_wgmma_tile_products_match_matmul(gen, d, which):
    """Each product of the tensor-core kernel alone on one tile, against
    torch.matmul in f32: S = Q K^T (both operands K-major) and O = P V (P
    from registers, V the MN-major B operand, the transpose bit)."""
    n = fa.WGMMA_BK
    if which == "qk":
        a, b = _randn(gen, 64, d), _randn(gen, n, d)
        want_fn = lambda a, b: a @ b.T  # noqa: E731
    else:
        a, b = _randn(gen, 64, n), _randn(gen, n, d)
        want_fn = lambda a, b: a @ b  # noqa: E731
    a, b = a.bfloat16(), b.bfloat16()
    got = fa.wgmma_tile(a, b, which)
    torch.cuda.synchronize()
    want = want_fn(a.float(), b.float())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _bshd(gen, b, s, h, d, dtype):
    """A (b, h, s, d) view of (b, s, h, d) memory, as the model hands it."""
    return _randn(gen, b, s, h, d, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("d", [32, 64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_q,seq_k,window", [(100, 100, 0), (64, 64, 16),
                                                (257, 257, 100), (3, 70, 0)])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_kernel_matches_plain(gen, d, dtype, seq_q, seq_k, window,
                                    layout):
    if layout == "bhsd":
        q = _randn(gen, 2, 3, seq_q, d, dtype=dtype)
        k = _randn(gen, 2, 3, seq_k, d, dtype=dtype)
        v = _randn(gen, 2, 3, seq_k, d, dtype=dtype)
    else:
        q = _bshd(gen, 2, seq_q, 3, d, dtype)
        k = _bshd(gen, 2, seq_k, 3, d, dtype)
        v = _bshd(gen, 2, seq_k, 3, d, dtype)
    for causal in (True, False):
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.plain_flash_attention(q, k, v, causal=causal,
                                        window=window)
        tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
            else dict(rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_cores")])
def test_flash_route_launch_counts(gen, dtype, route):
    q = _bshd(gen, 1, 256, 2, 128, dtype)
    before, by_route = fa.LAUNCHES, dict(fa.ROUTE_LAUNCHES)
    out = fa.flash_attention(q, q, q)
    assert fa.LAUNCHES == before + 1
    assert fa.ROUTE_LAUNCHES[route] == by_route[route] + 1
    other = ({"wgmma", "cuda_cores"} - {route}).pop()
    assert fa.ROUTE_LAUNCHES[other] == by_route[other]
    # written in (b, s, h, d) memory: the model's transpose back is free
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 112, 128])
def test_flash_strided_and_contiguous_bit_equal(gen, dtype, d):
    q, k, v = [_bshd(gen, 2, 300, 4, d, dtype) for _ in range(3)]
    for causal, window in ((True, 0), (True, 64), (False, 0)):
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq,window", [(256, 0), (256, 64), (256, 4096),
                                        (8192, 0), (8192, 64), (8192, 4096)])
def test_flash_d112_on_both_routes(gen, dtype, seq, window):
    """zamba2-7b's head dim, 112 (3584 / 32), on the model's (b, s, h, d)
    views: bf16 on the tensor cores through the d = 128 instance with
    columns 112-127 zero-filled, f32 on the CUDA cores' d = 112 instance;
    the window bites at 8192. The output is stored to 112 columns only."""
    route = fa.flash_route(dtype, 112)
    q, k, v = [_bshd(gen, 1, seq, 2, 112, dtype) for _ in range(3)]
    before = dict(fa.ROUTE_LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    assert fa.ROUTE_LAUNCHES[route] == before[route] + 1
    want = fa.plain_flash_attention(q, k, v, causal=True, window=window)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        assert _rel_norm_err(got, want) < BF16_REL_NORM
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    # (b, s, h, 112) memory: a store past column 111 would have written
    # zeros over the next head's first columns
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("window", [16, 64, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_windows_match_plain(gen, window, causal):
    q, k, v = [_bshd(gen, 2, 384, 4, 128, torch.bfloat16) for _ in range(3)]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.plain_flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_norm_err(got, want) < BF16_REL_NORM


def test_flash_main_shape_strided_matches_plain(gen):
    """olmo-1b's training shape, (2, 16, 2048, 128) bf16 causal, on the
    model's transposed views."""
    q, k, v = [_bshd(gen, 2, 2048, 16, 128, torch.bfloat16)
               for _ in range(3)]
    got = fa.flash_attention(q, k, v)
    want = fa.plain_flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_norm_err(got, want) < BF16_REL_NORM


@pytest.mark.parametrize("b,h,kv,d", [(8, 16, 16, 64), (4, 64, 8, 128)],
                         ids=["seamless-m4t-medium", "llama-3.2-vision-90b"])
def test_flash_cross_family_decoder_shapes_match_plain(gen, b, h, kv, d):
    """The decoders' self-attention at the scoring shapes of
    seamless-m4t-medium (8, 16, 2048, 64) and llama-3.2-vision-90b
    (4, 64, 2048, 128) in bf16, on the model's views: K and V as
    ``layers._repeat_kv`` hands them over (llama's 8 query heads per KV
    head copied before the transpose); one launch each, on wgmma."""
    from repro_torch.models.layers import _repeat_kv
    s = 2048
    q = _bshd(gen, b, s, h, d, torch.bfloat16)
    k, v = [_repeat_kv(_randn(gen, b, s, kv, d, dtype=torch.bfloat16),
                       h // kv).transpose(1, 2) for _ in range(2)]
    before = dict(fa.ROUTE_LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.ROUTE_LAUNCHES["wgmma"] == before["wgmma"] + 1
    want = fa.plain_flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_norm_err(got, want) < BF16_REL_NORM
    assert got.transpose(1, 2).is_contiguous()


def test_flash_refuses_views_it_cannot_read(gen):
    x = _randn(gen, 1, 2, 64, 64, dtype=torch.bfloat16)
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="last dim"):
        fa.flash_attention(x.transpose(2, 3), x, x)
    # rows of 36 bf16 (72 bytes): no TMA stride, but the CUDA cores read it
    y = _randn(gen, 1, 2, 64, 36, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention(y, y, y)
    assert fa.LAUNCHES == before
    yf = _randn(gen, 1, 2, 64, 36)[..., :32]     # f32 rows with a gap
    torch.testing.assert_close(fa.flash_attention(yf, yf, yf),
                               fa.plain_flash_attention(yf, yf, yf),
                               rtol=2e-4, atol=2e-5)


def test_flash_grads_on_card_match_plain(gen):
    q, k, v = [_randn(gen, 1, 2, 96, 64).requires_grad_(True)
               for _ in range(3)]
    g = _randn(gen, 1, 2, 96, 64)
    out = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(fa.plain_flash_attention(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=1e-5)


def test_kernels_refuse_what_they_do_not_take(gen):
    with pytest.raises(ValueError, match="head dim"):
        x = _randn(gen, 1, 1, 16, 48)
        fa.flash_attention(x, x, x)
    with pytest.raises(TypeError):
        x = _randn(gen, 1, 1, 16, 32, dtype=torch.float16)
        fa.flash_attention(x, x, x)
    with pytest.raises(TypeError):
        hier_agg.aggregate_shards(_randn(gen, 2, 8, dtype=torch.float16))
    with pytest.raises(TypeError):
        x = _randn(gen, 2, 128, dtype=torch.float16)
        ops.aggregate_and_apply(x, x[0], lr=0.1)
    with pytest.raises(ValueError, match="param"):
        x = _randn(gen, 2, 128)
        hier_agg.aggregate_and_apply(x, x[0, :100], 0.1)
    with pytest.raises(ValueError, match="head dim"):
        x = _randn(gen, 1, 32, 2, 128)
        hv, bc = _randn(gen, 2), _randn(gen, 1, 32, 8)
        ssd.ssd_scan(x, _randn(gen, 1, 32, 2), hv, bc, bc, hv, chunk=16)


@pytest.mark.parametrize("length", [512, 5000, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aggregate_and_apply_kernel_matches_plain(gen, length, dtype):
    x = _randn(gen, 4, length, dtype=dtype)
    p = _randn(gen, length, dtype=dtype)
    before = hier_agg.APPLY_LAUNCHES
    got = ops.aggregate_and_apply(x, p, lr=0.05)
    assert hier_agg.APPLY_LAUNCHES == before + 1
    want = hier_agg.plain_aggregate_and_apply(x, p, 0.05)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-5,
                               atol=1e-6)


def _ssd_args(gen, b, s, h, p, n, dtype):
    x = _randn(gen, b, s, h, p, dtype=dtype)
    dt = (_randn(gen, b, s, h).abs() * 0.5 + 0.01).to(dtype)
    A = -(_randn(gen, h).abs() + 0.5)
    B, C = _randn(gen, b, s, n, dtype=dtype), _randn(gen, b, s, n, dtype=dtype)
    return x, dt, A, B, C, _randn(gen, h)


@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 32), (256, 64),
                                     (300, 256), (512, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n", [(16, 8), (64, 128)])
def test_ssd_kernel_matches_plain(gen, s, chunk, dtype, p, n):
    args = _ssd_args(gen, 2, s, 4, p, n, dtype)
    before = ssd.LAUNCHES
    y, S = ops.ssd_scan(*args, chunk=chunk)
    assert ssd.LAUNCHES == before + 1
    c = min(chunk, max(16, s))
    pad = (-s) % c
    padded = [torch.nn.functional.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])
              if a.dim() > 1 else a for a in args]
    wy, wS = ssd.plain_ssd_scan(*padded, c)
    ytol = dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-4, atol=2e-4)
    stol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y.float(), wy[:, :s].float(), **ytol)
    torch.testing.assert_close(S, wS, **stol)


def test_ssd_kernel_reads_strided_B_C_views(gen):
    """B and C as the two halves of one (b, s, 2n) tensor, as the model
    splits them."""
    x, dt, A, _, _, D = _ssd_args(gen, 2, 128, 3, 64, 32, torch.float32)
    BC = _randn(gen, 2, 128, 64)
    B, C = torch.split(BC, 32, dim=-1)
    y, S = ssd.ssd_scan(x, dt, A, B, C, D, chunk=64)
    wy, wS = ssd.plain_ssd_scan(x, dt, A, B.contiguous(), C.contiguous(), D,
                                64)
    torch.testing.assert_close(y, wy, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(S, wS, rtol=2e-4, atol=2e-4)


def test_ssd_kernel_refuses_requires_grad(gen):
    x, dt, A, B, C, D = _ssd_args(gen, 1, 64, 2, 16, 8, torch.float32)
    before = ssd.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        ssd.ssd_scan(x.requires_grad_(True), dt, A, B, C, D, chunk=32)
    assert ssd.LAUNCHES == before


def _ssd_slow_args(gen, b, s, h, p, n, dtype):
    """Mamba2's initial ranges: dt log-uniform in [1e-3, 1e-1], A = -U[1, 16],
    so the state carried across chunks stays of size ~1."""
    x = _randn(gen, b, s, h, p, dtype=dtype)
    u = torch.rand(b, s, h, generator=gen, device="cuda")
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    A = -(1.0 + 15.0 * torch.rand(h, generator=gen, device="cuda"))
    B, C = _randn(gen, b, s, n, dtype=dtype), _randn(gen, b, s, n, dtype=dtype)
    return x, dt, A, B, C, _randn(gen, h)


def _check_ssd(got, want, dtype, rel_norm=None):
    (y, S), (wy, wS) = got, want
    ytol = dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-4, atol=2e-4)
    stol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y.float(), wy.float(), **ytol)
    torch.testing.assert_close(S, wS, **stol)
    if rel_norm is not None:
        assert _rel_norm_err(y, wy) < rel_norm


@pytest.mark.parametrize("which", ["cb", "px", "cs", "bx"])
def test_ssd_wgmma_tile_products_match_matmul(gen, which):
    """Each product of the tensor-core SSD kernel alone on one tile, by the
    kernel's own device code, against torch.matmul in f32: C B^T (both
    K-major), P x (P from registers, split), C S^ (S^ split, MN-major) and
    (B o w)^T x (the decayed B^T read transposed from the B tile, split)."""
    npad = ssd.WGMMA_NPAD
    c = _randn(gen, 64, npad, dtype=torch.bfloat16)
    bm = _randn(gen, 64, npad, dtype=torch.bfloat16)
    x = _randn(gen, 64, 64, dtype=torch.bfloat16)
    f = {"cb": None, "px": _randn(gen, 64, 64), "cs": _randn(gen, npad, 64),
         "bx": torch.rand(64, generator=gen, device="cuda")}[which]
    got = ssd.wgmma_tile(which, c=c, bm=bm, x=x, f=f)
    torch.cuda.synchronize()
    cf, bf, xf = c.float(), bm.float(), x.float()
    want = {"cb": lambda: cf @ bf.T, "px": lambda: f @ xf,
            "cs": lambda: cf @ f, "bx": lambda: (bf * f[:, None]).T @ xf}
    # hi + lo keeps ~16 bits of each f32 operand: 1e-4 relative to the sums
    torch.testing.assert_close(got, want[which](), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("s,chunk", [(256, 64), (320, 64), (300, 64),
                                     (2048, 256), (300, 256), (512, 128)])
@pytest.mark.parametrize("p,n", [(64, 128), (32, 64), (64, 16)])
def test_ssd_wgmma_route_matches_plain(gen, s, chunk, p, n):
    args = _ssd_args(gen, 2, s, 4, p, n, torch.bfloat16)
    args = (args[0], args[1].float()) + args[2:]
    c = min(chunk, max(16, s))
    assert ssd.ssd_route(torch.bfloat16, p, n, c) == "wgmma"
    before = dict(ssd.ROUTE_LAUNCHES)
    got = ops.ssd_scan(*args, chunk=chunk)
    assert ssd.ROUTE_LAUNCHES["wgmma"] == before["wgmma"] + 1
    pad = (-s) % c
    padded = [torch.nn.functional.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])
              if a.dim() > 1 else a for a in args]
    wy, wS = ssd.plain_ssd_scan(*padded, c)
    _check_ssd(got, (wy[:, :s], wS), torch.bfloat16, SSD_BF16_REL_NORM)


@pytest.mark.parametrize("route", ["wgmma", "cuda_cores"])
def test_ssd_slow_decay_matches_plain(gen, route):
    """A state that lives across four chunks, on both routes."""
    args = _ssd_slow_args(gen, 2, 1024, 4, 64, 128, torch.bfloat16)
    got = ssd.ssd_scan(*args, chunk=256, route=route)
    want = ssd.plain_ssd_scan(*args, 256)
    assert float(want[1].abs().max()) > 0.1
    _check_ssd(got, want, torch.bfloat16,
               SSD_BF16_REL_NORM if route == "wgmma" else None)


@pytest.mark.parametrize("route", ["wgmma", "cuda_cores"])
def test_ssd_scoring_shape_on_both_routes(gen, route):
    """mamba2-2.7b's scoring shape, (8, 2048, 80, 64), n 128, chunk 256,
    x, B, C bf16 and dt, A f32, B and C the halves of one (b, s, 2n)
    tensor as the model splits them."""
    x = _randn(gen, 8, 2048, 80, 64, dtype=torch.bfloat16)
    dt = _randn(gen, 8, 2048, 80).abs() * 0.5 + 0.01
    A = -(_randn(gen, 80).abs() + 0.5)
    B, C = torch.split(_randn(gen, 8, 2048, 256, dtype=torch.bfloat16), 128,
                       dim=-1)
    D = _randn(gen, 80, dtype=torch.bfloat16)
    before = dict(ssd.ROUTE_LAUNCHES)
    got = ssd.ssd_scan(x, dt, A, B, C, D, chunk=256, route=route)
    assert ssd.ROUTE_LAUNCHES[route] == before[route] + 1
    want = ssd.plain_ssd_scan(x, dt, A, B, C, D, 256)
    _check_ssd(got, want, torch.bfloat16,
               SSD_BF16_REL_NORM if route == "wgmma" else None)


@pytest.mark.parametrize("route", ["wgmma", "cuda_cores"])
def test_ssd_zamba2_state_64_on_both_routes(gen, route):
    """zamba2-7b's SSD: 112 heads of 64, state n 64 (padded to WGMMA_NPAD
    inside the tensor-core kernel), chunk 256, B and C the halves of one
    (b, s, 2n) tensor, at a cut batch and sequence."""
    x = _randn(gen, 1, 1024, 112, 64, dtype=torch.bfloat16)
    dt = _randn(gen, 1, 1024, 112).abs() * 0.5 + 0.01
    A = -(_randn(gen, 112).abs() + 0.5)
    B, C = torch.split(_randn(gen, 1, 1024, 128, dtype=torch.bfloat16), 64,
                       dim=-1)
    D = _randn(gen, 112, dtype=torch.bfloat16)
    assert ssd.ssd_route(torch.bfloat16, 64, 64, 256) == "wgmma"
    before = dict(ssd.ROUTE_LAUNCHES)
    got = ssd.ssd_scan(x, dt, A, B, C, D, chunk=256, route=route)
    assert ssd.ROUTE_LAUNCHES[route] == before[route] + 1
    want = ssd.plain_ssd_scan(x, dt, A, B, C, D, 256)
    _check_ssd(got, want, torch.bfloat16,
               SSD_BF16_REL_NORM if route == "wgmma" else None)


def test_ssd_routes_by_dtype_and_shape(gen):
    bf = _ssd_args(gen, 1, 256, 2, 64, 128, torch.bfloat16)
    f32 = _ssd_args(gen, 1, 256, 2, 64, 128, torch.float32)
    small = _ssd_args(gen, 1, 64, 2, 16, 8, torch.bfloat16)
    before = dict(ssd.ROUTE_LAUNCHES)
    ssd.ssd_scan(*bf, chunk=256)
    ssd.ssd_scan(*f32, chunk=256)
    ssd.ssd_scan(*small, chunk=16)
    ssd.ssd_scan(*bf, chunk=256, route="cuda_cores")
    assert ssd.ROUTE_LAUNCHES == {"wgmma": before["wgmma"] + 1,
                                  "cuda_cores": before["cuda_cores"] + 3}


def test_ssd_wgmma_refuses_what_it_cannot_take(gen):
    x, dt, A, B, C, D = _ssd_args(gen, 1, 128, 2, 64, 128, torch.bfloat16)
    before = ssd.LAUNCHES
    # rows of 130 bf16 (260 bytes): no TMA stride
    Bw = _randn(gen, 1, 128, 130, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="16 bytes"):
        ssd.ssd_scan(x, dt, A, Bw, C, D, chunk=64)
    with pytest.raises(ValueError, match="wgmma route"):
        ssd.ssd_scan(x, dt, A, B, C, D, chunk=32, route="wgmma")
    with pytest.raises(ValueError, match="wgmma route"):
        ssd.ssd_scan(x.float(), dt, A, B.float(), C.float(), D, chunk=64,
                     route="wgmma")
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.half(), dt, A, B.half(), C.half(), D, chunk=64)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd.ssd_scan(x.float().requires_grad_(True), dt, A, B.float(),
                     C.float(), D, chunk=64)
    assert ssd.LAUNCHES == before
    # the CUDA-core route reads the same unaligned view
    got = ssd.ssd_scan(x, dt, A, Bw, C, D, chunk=64, route="cuda_cores")
    _check_ssd(got, ssd.plain_ssd_scan(x, dt, A, Bw, C, D, 64),
               torch.bfloat16)


# ---------------------------------------------------------------------------
# the flash backward: dK / dV over key tiles, dQ over query tiles
# ---------------------------------------------------------------------------

# ||got - want|| / ||want|| of each bf16 gradient against the plain
# backward: P and dS are rounded to bf16 for the products, where the
# forward rounds only P
BWD_BF16_REL_NORM = 1e-2


def _bwd_case(gen, b, h, sq, sk, d, dtype, causal, window):
    """Inputs of one backward on (b, s, h, d) memory, as the model hands
    them: q, k, v, the kernel forward's output and lse, and dO in the
    output's layout."""
    q = _bshd(gen, b, sq, h, d, dtype)
    k = _bshd(gen, b, sk, h, d, dtype)
    v = _bshd(gen, b, sk, h, d, dtype)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    g = _bshd(gen, b, sq, h, d, dtype)
    return q, k, v, out, lse, g


@pytest.mark.parametrize("d", [32, 64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_q,seq_k,causal,window",
                         [(256, 256, True, 0), (300, 300, True, 100),
                          (192, 192, True, 16), (100, 100, False, 0),
                          (3, 70, True, 0)])
def test_flash_bwd_kernel_matches_plain(gen, d, dtype, seq_q, seq_k,
                                        causal, window):
    case = _bwd_case(gen, 2, 3, seq_q, seq_k, d, dtype, causal, window)
    q, k, v, out, lse = case[:5]
    torch.testing.assert_close(
        lse, fa.plain_flash_lse(q, k, causal=causal, window=window),
        rtol=1e-5, atol=1e-5)
    route = fa.flash_route(dtype, d)
    before = dict(fa.BWD_ROUTE_LAUNCHES)
    got = fa.flash_attention_bwd(*case, causal=causal, window=window)
    assert fa.BWD_ROUTE_LAUNCHES[route] == before[route] + 1
    want = fa.plain_flash_attention_bwd(*case, causal=causal, window=window)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert a.transpose(1, 2).is_contiguous()
        if dtype == torch.bfloat16:
            torch.testing.assert_close(a.float(), w.float(), rtol=2e-2,
                                       atol=2e-2)
            assert _rel_norm_err(a, w) < BWD_BF16_REL_NORM
        else:
            torch.testing.assert_close(a, w, rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_is_deterministic(gen, dtype):
    case = _bwd_case(gen, 2, 4, 512, 512, 128, dtype, True, 0)
    first = fa.flash_attention_bwd(*case, causal=True)
    second = fa.flash_attention_bwd(*case, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)



# olmo-1b's leaves, the 16 layers stacked (the embedding tied to the head),
# and an odd length for the kernels' scalar tail
OLMO_LEAF_SHAPES = [(50304, 2048), (16, 2048, 2048), (16, 2048, 8192),
                    (16, 8192, 2048), (100_003,)]


@pytest.mark.parametrize("shape,dtype", [
    *[(s, torch.bfloat16) for s in OLMO_LEAF_SHAPES],
    ((16, 2048, 2048), torch.float32), ((100_003,), torch.float32)])
def test_adamw_kernel_matches_plain_over_twenty_steps(gen, shape, dtype):
    """Twenty steps of the kernel, each held against plain_adamw_update on
    the kernel's own state: m, v and the new parameters bit-equal (the
    plain version's arithmetic, operation for operation); the clip engaged
    on the even steps (gradient norm ~3), not on the odd ones (~0.5) nor on
    every fifth (no scale); the sum of squares within 1e-6 relative of the
    plain one and bit-equal between two calls."""
    p = _randn(gen, *shape, dtype=dtype)
    m = torch.zeros(shape, device="cuda")
    v = torch.zeros(shape, device="cuda")
    b1, b2 = 0.9, 0.999
    for step in range(1, 21):
        norm = 0.5 if step % 2 else 3.0
        g = (_randn(gen, *shape) * (norm / math.sqrt(p.numel()))).to(dtype)
        sq = adamw_k.sum_squares(g)
        assert torch.equal(sq, adamw_k.sum_squares(g))
        torch.testing.assert_close(sq, adamw_k.plain_sum_squares(g),
                                   rtol=1e-6, atol=0)
        scale = None if step % 5 == 0 else torch.clamp(
            1.0 / (torch.sqrt(sq) + 1e-9), max=1.0)
        hp = dict(lr=3e-4 * (1 + step % 3), b1=b1, b2=b2,
                  bc1=1 - b1 ** step, bc2=1 - b2 ** step, eps=1e-8,
                  weight_decay=0.01)
        m_plain, v_plain = m.clone(), v.clone()
        before = adamw_k.LAUNCHES
        new = adamw_k.adamw_update(p, g, m, v, scale, **hp)
        assert adamw_k.LAUNCHES == before + 1
        want = adamw_k.plain_adamw_update(p, g, m_plain, v_plain, scale, **hp)
        assert new.dtype == dtype and new.shape == p.shape
        for got, ref in ((m, m_plain), (v, v_plain), (new, want)):
            assert torch.equal(got, ref), (
                f"step {step}: max abs diff "
                f"{float((got.float() - ref.float()).abs().max())}")
        p = new
    assert bool(torch.isfinite(p.float()).all())


def test_adamw_kernel_unaligned_views_take_the_scalar_path(gen):
    """Views 2 bytes / 4 bytes off 16-byte alignment run the scalar
    instance and give what the aligned call gives."""
    n = 4099
    p = _randn(gen, n + 1, dtype=torch.bfloat16)
    g = _randn(gen, n + 1, dtype=torch.bfloat16)
    m = _randn(gen, n + 1) * 0.1
    v = _randn(gen, n + 1).abs() * 0.01
    hp = dict(lr=1e-3, b1=0.9, b2=0.999, bc1=0.19, bc2=0.002, eps=1e-8,
              weight_decay=0.01)
    aligned = [t[1:].clone() for t in (p, g, m, v)]
    want = adamw_k.adamw_update(*aligned, **hp)
    got = adamw_k.adamw_update(p[1:], g[1:], m[1:], v[1:], **hp)
    assert torch.equal(got, want)
    assert torch.equal(m[1:], aligned[2]) and torch.equal(v[1:], aligned[3])
    assert torch.equal(adamw_k.sum_squares(g[1:]),
                       adamw_k.sum_squares(aligned[1]))


def test_adamw_update_launches_once_a_leaf(gen):
    """AdamW.update on a CUDA tree: one update and one sum-of-squares
    launch a leaf, and the result equals the plain path's."""
    from repro_torch.core import tree as T
    from repro_torch.optim import AdamW
    params = {"a": _randn(gen, 64, 33, dtype=torch.bfloat16),
              "b": {"c": _randn(gen, 1000), "d": _randn(gen, 8)}}
    grads = {"a": _randn(gen, 64, 33, dtype=torch.bfloat16),
             "b": {"c": _randn(gen, 1000) * 5, "d": _randn(gen, 8)}}
    opt = AdamW(lr=1e-3)
    before = (adamw_k.LAUNCHES, adamw_k.SUMSQ_LAUNCHES)
    new, _ = opt.update(grads, opt.init(params), params)
    assert (adamw_k.LAUNCHES, adamw_k.SUMSQ_LAUNCHES) == (before[0] + 3,
                                                          before[1] + 3)
    cpu_grads, cpu_params = (T.tree_map(lambda x: x.cpu(), t)
                             for t in (grads, params))
    want, _ = opt.update(cpu_grads, opt.init(cpu_params), cpu_params)
    for got, ref in zip(T.leaves(new), T.leaves(want)):
        torch.testing.assert_close(got.cpu().float(), ref.float(),
                                   rtol=1e-2 if got.dtype == torch.bfloat16
                                   else 1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_scale_matches_plain_on_both_routes(gen, dtype):
    """A model's own softmax scale (granite-4.0-h's 1/128 at d = 128, and
    one above the default), forward, logsumexp and backward, against the
    plain versions at that scale; without it, the kernels' d^-0.5 as
    always."""
    case = _bwd_case(gen, 2, 4, 300, 300, 128, dtype, True, 0)
    q, k, v, _, _, g = case
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=5e-4, atol=1e-5)
    for scale in (1 / 128, 0.125):
        out, lse = fa.flash_attention(q, k, v, return_lse=True, scale=scale)
        torch.testing.assert_close(
            out.float(), fa.plain_flash_attention(q, k, v,
                                                  scale=scale).float(),
            **tol)
        torch.testing.assert_close(lse, fa.plain_flash_lse(q, k,
                                                           scale=scale),
                                   rtol=1e-5, atol=1e-5)
        got = fa.flash_attention_bwd(q, k, v, out, lse, g, scale=scale)
        want = fa.plain_flash_attention_bwd(q, k, v, out, lse, g,
                                            scale=scale)
        for a, w in zip(got, want):
            torch.testing.assert_close(a.float(), w.float(), **tol)
            if dtype == torch.bfloat16:
                assert _rel_norm_err(a, w) < BWD_BF16_REL_NORM
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention(q, k, v, scale=128 ** -0.5))


def test_dropless_moe_grouped_products_match_plain(gen):
    """The routed experts' grouped products (``torch._grouped_mm`` on a
    CUDA bf16 tensor) against the plain per-expert products on the same
    rows, experts with no rows among them; and the whole layer's counters
    against the routing of the same logits."""
    from repro_torch.core import spans
    from repro_torch.models import moe
    from repro_torch.models.base import ModelConfig
    held, d, f = 12, 512, 128
    ex = {"w1": _randn(gen, held, d, 2 * f, dtype=torch.bfloat16) / 20,
          "w2": _randn(gen, held, f, d, dtype=torch.bfloat16) / 10}
    rows = [0, 300, 1, 0, 517, 64, 2, 999, 0, 33, 128, 5]
    counts = torch.tensor(rows, device="cuda")
    xs = _randn(gen, sum(rows), d, dtype=torch.bfloat16)
    got = moe.held_products(ex, xs, counts, rows)
    want = moe.plain_held_products(ex, xs, rows)
    assert got.shape == want.shape == (sum(rows), d)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_norm_err(got, want) < 5e-3
    cfg = ModelConfig(d_model=d, d_ff=f, n_experts=24, experts_held=held,
                      top_k=6, dtype=torch.bfloat16)
    p = {"router": _randn(gen, d, 24, dtype=torch.bfloat16) / 20,
         "experts": ex}
    x = _randn(gen, 2, 700, d, dtype=torch.bfloat16)
    spans.clear()
    with spans.recording():
        out = moe.dropless_moe(p, cfg, x, first=6)
    counts = {c.name: c.value for c in spans.counted()}
    spans.clear()
    top = torch.topk((x.reshape(-1, d) @ p["router"]).float(), 6,
                     dim=-1).indices
    assert counts["moe.pairs_held"] == int(((top >= 6) & (top < 18)).sum())
    assert counts["moe.pairs_dropped"] == 0
    assert out.dtype == torch.float32 and bool(out.isfinite().all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_expert_products_refuse_other_dtypes_on_the_card(gen, dtype):
    """On the card the expert products are the grouped ones or a refusal:
    a float32 or float16 call never falls back to the per-expert loop."""
    from repro_torch.models import moe
    rows = [5, 0, 3]
    ex = {"w1": _randn(gen, 3, 64, 32, dtype=dtype),
          "w2": _randn(gen, 3, 16, 64, dtype=dtype)}
    xs = _randn(gen, sum(rows), 64, dtype=dtype)
    with pytest.raises(TypeError, match="bf16"):
        moe.held_products(ex, xs, torch.tensor(rows, device="cuda"), rows)


# ---------------------------------------------------------------------------
# the serving engine's captured decode step (serving/engine.py::DecodeGraph)
# ---------------------------------------------------------------------------

GRAPH_LAYERS = 4        # mamba2-2.7b cut in depth, at its published widths


@pytest.fixture(scope="module")
def mamba2_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.configs import ARCHS
    from repro_torch.serving import ServingEngine
    cfg = ARCHS["mamba2-2.7b"].replace(n_layers=GRAPH_LAYERS,
                                       use_ssd_kernel=True)
    assert (cfg.d_model, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state) \
        == (2560, 80, 64, 128)
    return ServingEngine(cfg, seed=0, device="cuda")


def _graph_requests(cfg, b, plen, new, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.RandomState(seed)
    return [Request(i, rng.randint(0, cfg.vocab_size, plen).astype(np.int32),
                    new) for i in range(b)]


def _eager_tokens(engine, reqs, monkeypatch):
    """The engine's greedy tokens through the eager decode loop, on the
    same weights."""
    from repro_torch.models import registry
    from repro_torch.serving import ServingEngine
    with monkeypatch.context() as m:
        m.setattr(registry, "decode_replayable", lambda cfg, device: False)
        eager = ServingEngine(engine.cfg, params=engine.params, device="cuda")
        out = eager.serve_batch(reqs)
        assert eager.graphs == {}
    return [c.tokens for c in out]


def _same_tokens(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens.tolist() == w.tolist()


@pytest.mark.parametrize("plen", [256, 300, 512, 4096])
def test_graphed_decode_equals_eager_bit_for_bit(mamba2_engine, plen,
                                                 monkeypatch):
    """Batch 8, after a prefill through the SSD kernel (one record of
    ``ssd.kernel`` a layer, nothing counted by the decode steps): the
    replayed step's logits equal the eager step's bit for bit, step after
    step, from the same prefill cache, and so do the engine's greedy
    tokens."""
    import numpy as np
    from repro_torch.core import spans
    from repro_torch.models import registry
    from repro_torch.serving.engine import DecodeGraph
    eng, cfg = mamba2_engine, mamba2_engine.cfg
    reqs = _graph_requests(cfg, 8, plen, 8, seed=plen)
    spans.clear()
    with spans.recording():
        got = eng.serve_batch(reqs)
    assert [(c.name, c.value) for c in spans.counted()] == [
        ("ssd.kernel", 1)] * GRAPH_LAYERS + [
        ("serve.decode_replayed", 7), ("serve.decode_eager", 0)]
    spans.clear()
    assert 8 in eng.graphs
    _same_tokens(got, _eager_tokens(eng, reqs, monkeypatch))

    toks = torch.from_numpy(np.stack([r.prompt for r in reqs])).cuda()
    with torch.no_grad():
        logits, cache = registry.prefill(eng.params, cfg, {"tokens": toks})
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        g = DecodeGraph(eng.params, cfg, cache, tok, plen)
        for t in range(6):
            logits, cache = registry.decode_step(eng.params, cfg, cache,
                                                 plen + t, tok)
            tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
            assert torch.equal(g.step(), tok)
            assert torch.equal(g.logits, logits), t
        for k, x in cache.items():
            assert torch.equal(g.cache[k], x), k


def test_graph_is_reused_and_keeps_no_state(mamba2_engine, monkeypatch):
    """Two batches in a row with different prompts, of two lengths, reuse
    one capture; each gives the eager tokens, and the first batch served
    again gives its own tokens again."""
    eng, cfg = mamba2_engine, mamba2_engine.cfg
    a = _graph_requests(cfg, 8, 256, 6, seed=1)
    b = _graph_requests(cfg, 8, 512, 6, seed=2)
    first = eng.serve_batch(a)
    graph = eng.graphs[8]
    second = eng.serve_batch(b)
    again = eng.serve_batch(a)
    assert eng.graphs[8] is graph and list(eng.graphs) == [8]
    _same_tokens(first, _eager_tokens(eng, a, monkeypatch))
    _same_tokens(second, _eager_tokens(eng, b, monkeypatch))
    _same_tokens(again, [c.tokens for c in first])


def test_each_batch_size_captures_its_own_graph(mamba2_engine, monkeypatch):
    eng, cfg = mamba2_engine, mamba2_engine.cfg
    eng.serve_batch(_graph_requests(cfg, 8, 256, 4, seed=3))
    eight = eng.graphs[8]
    reqs = _graph_requests(cfg, 4, 256, 6, seed=4)
    got = eng.serve_batch(reqs)
    assert eng.graphs[8] is eight and eng.graphs[4] is not eight
    assert eng.graphs[4].tok.shape == (4, 1)
    _same_tokens(got, _eager_tokens(eng, reqs, monkeypatch))


def test_replacing_params_drops_the_graphs(mamba2_engine, monkeypatch):
    from repro_torch.models import registry
    eng, cfg = mamba2_engine, mamba2_engine.cfg
    reqs = _graph_requests(cfg, 8, 256, 6, seed=5)
    eng.serve_batch(reqs)
    assert eng.graphs
    old = eng.params
    eng.params = registry.init(1, cfg, "cuda")
    assert eng.graphs == {}
    got = eng.serve_batch(reqs)
    assert list(eng.graphs) == [8]
    _same_tokens(got, _eager_tokens(eng, reqs, monkeypatch))
    eng.params = old


# ---------------------------------------------------------------------------
# the prefill from the zero state through the SSD kernel (models/mamba2.py)
# ---------------------------------------------------------------------------

# the kernel prefill's logits and cache against their f32 twin: within
# this many times the ssd_chunked bf16 prefill's own distance from it.
# Random-weight Mamba2 layers amplify every bf16 rounding, the plain
# path's as much (a layer-3 state of GRAPH_LAYERS lies 1.0e-2 to 1.5e-2
# from the ssd_chunked prefill's on an H100), so the two bf16 paths are
# held by their distance from f32, as chip_smoke.py's TP_BF16_NOISE_RATIO
# holds a split program
PREFILL_BF16_NOISE_RATIO = 1.25


@pytest.mark.parametrize("plen", [256, 300, 4096])
def test_kernel_prefill_matches_chunked_prefill(mamba2_engine, plen,
                                                monkeypatch):
    """mamba2-2.7b's widths at GRAPH_LAYERS, batch 8: the prefill from the
    zero state launches the tensor-core SSD kernel once a layer, each call
    held against its plain version on the model's own (padded) inputs at
    the kernel's bf16 tolerances; the first layer's conv states equal the
    ``ssd_chunked`` prefill's bit for bit (they precede the SSD) and its
    state lies within the kernel's state tolerance of it; every cache
    leaf of every layer and the logits lie no further from the f32
    ``ssd_chunked`` prefill than PREFILL_BF16_NOISE_RATIO times the bf16
    ``ssd_chunked`` prefill does."""
    from repro_torch.core import tree as T
    from repro_torch.models import registry
    eng, cfg = mamba2_engine, mamba2_engine.cfg
    gen = torch.Generator(device="cuda").manual_seed(plen)
    toks = torch.randint(0, cfg.vocab_size, (8, plen), generator=gen,
                         device="cuda", dtype=torch.int32)
    scan, calls = ssd.ssd_scan, []

    def held(x, dt, A, B, C, D, *, chunk):
        got = scan(x, dt, A, B, C, D, chunk=chunk)
        _check_ssd(got, ssd.plain_ssd_scan(x, dt, A, B, C, D, chunk),
                   torch.bfloat16, SSD_BF16_REL_NORM)
        calls.append(x.shape)
        return got

    monkeypatch.setattr(ssd, "ssd_scan", held)
    before = dict(ssd.ROUTE_LAUNCHES)
    with torch.no_grad():
        logits, cache = registry.prefill(eng.params, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        assert ssd.ROUTE_LAUNCHES == {
            "wgmma": before["wgmma"] + cfg.n_layers,
            "cuda_cores": before["cuda_cores"]}
        assert len(calls) == cfg.n_layers
        plain_logits, plain = registry.prefill(
            eng.params, cfg.replace(use_ssd_kernel=False), {"tokens": toks})
        f32 = cfg.replace(dtype=torch.float32, use_ssd_kernel=False)
        f32_logits, f32_cache = registry.prefill(
            T.tree_map(lambda p: p.float(), eng.params), f32,
            {"tokens": toks})
    # the ssd_chunked prefills launch no kernel
    assert ssd.ROUTE_LAUNCHES["wgmma"] == before["wgmma"] + cfg.n_layers
    assert cache["ssm"].dtype == torch.float32
    for k in ("conv_x", "conv_BC"):
        assert torch.equal(cache[k][0], plain[k][0]), k
    torch.testing.assert_close(cache["ssm"][0], plain["ssm"][0], rtol=1e-2,
                               atol=1e-2)
    pairs = [("logits", logits, plain_logits, f32_logits)] + [
        (f"{k}[{i}]", cache[k][i], plain[k][i], f32_cache[k][i])
        for k in ("conv_x", "conv_BC", "ssm") for i in range(cfg.n_layers)]
    for name, got, base, want in pairs:
        assert got.shape == base.shape == want.shape, name
        err, noise = _rel_norm_err(got, want), _rel_norm_err(base, want)
        assert math.isfinite(err) and err <= PREFILL_BF16_NOISE_RATIO \
            * noise, (name, err, noise)
