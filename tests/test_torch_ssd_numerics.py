"""The numerics of the tensor-core SSD kernel (``csrc/ssd_scan_wgmma.cu``),
emulated in plain PyTorch on the CPU and held against the reference's
Pallas kernel (``repro.kernels.ops.ssd_scan``, interpret mode) at the
scoring widths of mamba2-2.7b (p 64, n 128, chunk 256, s 2048, a few heads).

The kernel feeds the tensor cores bf16 operands and accumulates in f32.
x, B and C are bf16 already; three operands are f32 values: P = C B^T o
exp(seg_i - seg_j) o dt_j, the state at a chunk's start S^, and the decayed
B^T of the state update. The kernel passes each as hi = bf16(v) and
lo = bf16(v - hi), two products into one accumulator. ``emulate`` repeats
that arithmetic (and, for comparison, one bf16 rounding of each operand).

    python tests/test_torch_ssd_numerics.py

prints, for each variant, the worst element of y and of the state as a
multiple of the reference's bf16 tolerance and y's relative norm error."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402

# ||y - y_ref|| / ||y_ref|| that the tensor-core route is held to, here,
# in chip_smoke.py phase 7 and in tests/test_torch_cuda.py: about twice the
# split emulation's largest value at the scoring widths (5.2e-5 to 1.04e-4
# over both distributions and three seeds, against this reference and the
# port's plain version; nearly all of it is y's own rounding to bf16). One
# bf16 rounding of the three operands gives 1.8e-3 to 3.3e-3
SSD_BF16_REL_NORM = 2.5e-4
Y_TOL = dict(rtol=5e-2, atol=5e-2)      # tests/test_kernels.py, bf16
S_TOL = dict(rtol=1e-2, atol=1e-2)
WIDTHS = dict(p=64, n=128, chunk=256, s=2048)


def inputs(dist: str, b: int, s: int, h: int, p: int, n: int, seed: int = 0):
    """numpy inputs. "reference": tests/test_kernels.py's distribution
    (dt = |N| / 2 + 0.01, A = -(|N| + 0.5): dt A ~ -0.5 a token, so a
    256-token chunk decays the carried state by ~e^-128). "slow_decay":
    Mamba2's initial ranges, dt log-uniform in [1e-3, 1e-1] and
    A = -U[1, 16], so the state lives across chunks."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p)
    if dist == "reference":
        dt = np.abs(rng.randn(b, s, h)) * 0.5 + 0.01
        A = -(np.abs(rng.randn(h)) + 0.5)
    else:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
        A = -rng.uniform(1.0, 16.0, h)
    B, C, D = rng.randn(b, s, n), rng.randn(b, s, n), rng.randn(h)
    return x, dt, A, B, C, D


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _split(v):
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _bf16_product(a, b, mode):
    """a @ b with ``a`` f32 (the operand the kernel splits) and ``b`` exact
    bf16, accumulated in f32."""
    if mode == "split":
        hi, lo = _split(a)
        return hi @ b + lo @ b
    return a.bfloat16().float() @ b


def emulate(x, dt, A, B, C, D, chunk: int, mode: str = "split"):
    """The kernel's function with its operand roundings, in f32 on the CPU.
    x, B, C bf16; dt, A, D f32. mode: "split" (the kernel), "single" (P, S^
    and the decayed B^T each rounded once to bf16), "single_nodt" (P
    without dt rounded once, times x dt rounded to bf16)."""
    b, s, h, p = x.shape
    xf, Bf, Cf = x.float(), B.float(), C.float()
    dtf, Af, Df = dt.float(), A.float(), D.float()
    idx = torch.arange(chunk)
    causal = idx[:, None] >= idx[None, :]
    S = torch.zeros(b, h, B.shape[-1], p)
    ys = []
    for c0 in range(0, s, chunk):
        xc = xf[:, c0:c0 + chunk].permute(0, 2, 1, 3)            # (b, h, Q, p)
        dtc = dtf[:, c0:c0 + chunk].permute(0, 2, 1)             # (b, h, Q)
        Bc, Cc = Bf[:, None, c0:c0 + chunk], Cf[:, None, c0:c0 + chunk]
        seg = torch.cumsum(dtc * Af[None, :, None], dim=-1)      # sequential
        G = Cc @ Bc.transpose(-1, -2)                            # (b, 1, Q, Q)
        diff = torch.where(causal, seg[..., :, None] - seg[..., None, :],
                           -torch.inf)
        if mode == "single_nodt":
            Pm = G * torch.exp(diff)
            y = _bf16_product(Pm, (xc * dtc[..., None]).bfloat16().float(),
                              mode)
        else:
            Pm = G * torch.exp(diff) * dtc[..., None, :]
            y = _bf16_product(Pm, xc, mode)
        y = y + torch.exp(seg)[..., None] * _bf16_product(
            S.transpose(-1, -2), Cc.transpose(-1, -2), mode).transpose(-1, -2)
        seg_last = seg[..., -1:]
        w = dtc * torch.exp(seg_last - seg)                      # (b, h, Q)
        Bw = (Bc.transpose(-1, -2) * w[..., None, :])            # (b, h, n, Q)
        S = S * torch.exp(seg_last)[..., None] + _bf16_product(Bw, xc, mode)
        ys.append((y + Df[None, :, None, None] * xc).permute(0, 2, 1, 3))
    return torch.cat(ys, dim=1).bfloat16(), S


def _reference(arrs):
    x, dt, A, B, C, D = arrs
    js = [jnp.array(np.asarray(_bf16(a).float()), jnp.bfloat16)
          for a in (x, B, C)]
    jy, jS = jops.ssd_scan(js[0], jnp.array(dt, jnp.float32),
                           jnp.array(A, jnp.float32), js[1], js[2],
                           jnp.array(D, jnp.float32), chunk=WIDTHS["chunk"])
    return (torch.from_numpy(np.array(jy, np.float32)),
            torch.from_numpy(np.array(jS, np.float32)))


def _torch_args(arrs):
    x, dt, A, B, C, D = arrs
    f32 = [torch.from_numpy(np.asarray(a, np.float32)) for a in (dt, A, D)]
    return _bf16(x), f32[0], f32[1], _bf16(B), _bf16(C), f32[2]


def worst(got, want, rtol, atol):
    """The largest |got - want| / (atol + rtol |want|): below 1 passes."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def rel_norm(got, want):
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


def measure(dist: str, h: int, mode: str, seed: int = 0):
    arrs = inputs(dist, 1, WIDTHS["s"], h, WIDTHS["p"], WIDTHS["n"], seed)
    want_y, want_S = _reference(arrs)
    y, S = emulate(*_torch_args(arrs), WIDTHS["chunk"], mode)
    return (worst(y, want_y, **Y_TOL), worst(S, want_S, **S_TOL),
            rel_norm(y, want_y), float(want_S.abs().max()))


@pytest.mark.parametrize("dist", ["reference", "slow_decay"])
def test_split_bf16_holds_the_reference_tolerances(dist):
    """The kernel's arithmetic, emulated, against the reference's Pallas
    kernel at the scoring widths: y within 5e-2, the state within 1e-2,
    and y's relative norm error within SSD_BF16_REL_NORM."""
    wy, ws, rel, _ = measure(dist, h=4, mode="split")
    assert wy < 1 and ws < 1, (wy, ws)
    assert rel < SSD_BF16_REL_NORM, rel


def test_slow_decay_carries_the_state_across_chunks():
    """The slow-decay inputs leave a state of size ~1 at the end, where the
    reference distribution's state is ~e^-128 of what any chunk but the
    last put in: only these cases test the hand-over between chunks."""
    *_, peak_slow = measure("slow_decay", h=2, mode="split", seed=1)
    _, dt, A, *_ = inputs("reference", 1, 256, 2, 64, 128)
    assert peak_slow > 0.1
    assert float(np.exp((dt[0] * A).sum(0)).max()) < 1e-30


def test_split_is_far_closer_than_one_bf16_rounding():
    """Why the split: one bf16 rounding of P, S^ and the decayed B^T moves
    y an order of magnitude further from the reference than hi + lo."""
    split = measure("reference", h=2, mode="split", seed=2)
    single = measure("reference", h=2, mode="single", seed=2)
    assert split[0] * 10 < single[0] and split[2] * 2 < single[2]


if __name__ == "__main__":
    for dist in ("reference", "slow_decay"):
        for mode in ("split", "single", "single_nodt"):
            wy, ws, rel, peak = measure(dist, h=8, mode=mode)
            print(f"{dist:10s} {mode:11s} worst y / tol {wy:.4f}  worst "
                  f"state / tol {ws:.4f}  y rel norm {rel:.3e}  max |S| "
                  f"{peak:.3e}")
