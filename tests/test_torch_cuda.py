"""Card-only checks of the hand-written CUDA kernels: each is held against
its plain version on the card, counts its launches, and refuses what it
does not take. Marked ``cuda``; they skip on a machine without a card and
run there with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
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
