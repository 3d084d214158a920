"""Card-only checks of the hand-written CUDA kernels: each is held against
its plain version on the card, counts its launches, and refuses what it
does not take. Marked ``cuda``; they skip on a machine without a card and
run there with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import hier_agg, ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


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


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_q,seq_k,window", [(100, 100, 0), (64, 64, 16),
                                                (257, 257, 100), (3, 70, 0)])
def test_flash_kernel_matches_plain(gen, d, dtype, seq_q, seq_k, window):
    q = _randn(gen, 2, 3, seq_q, d, dtype=dtype)
    k = _randn(gen, 2, 3, seq_k, d, dtype=dtype)
    v = _randn(gen, 2, 3, seq_k, d, dtype=dtype)
    for causal in (True, False):
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.plain_flash_attention(q, k, v, causal=causal,
                                        window=window)
        tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
            else dict(rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(got.float(), want.float(), **tol)


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
    with pytest.raises(NotImplementedError, match="B2"):
        x = _randn(gen, 2, 128)
        ops.aggregate_and_apply(x, x[0], lr=0.1)
