"""What the plain references share: the weights the benchmark makes from a
seed, float32 matmuls with TF32 off or the fp8 control's rounded ones, the
token loss and AdamW."""
from __future__ import annotations

import math

import torch

from perfbench import yardstick


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def matmul(precision: str = "f32"):
    """a @ b in float32 ("f32"), or with both operands first rounded to
    fp8 e4m3 ("fp8": the control, one precision below the bf16 the
    configurations state)."""
    if precision == "f32":
        return lambda a, b: a @ b
    if precision == "fp8":
        return lambda a, b: yardstick.fp8_round(a) @ yardstick.fp8_round(b)
    raise ValueError(precision)


def set_path(tree: dict, path: str, value):
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def make_weights(spec, seed: int, device, dtype):
    """The tree of ``spec`` [(path, shape, init)] in ``dtype`` on
    ``device``: every ("normal", scale) leaf from one draw of N(0, 1) by a
    generator on the device seeded from ``seed``, scaled; "ones", "zeros"
    and {} as they say; ("a_log",) log U[1, 16] and ("dt_bias",) the
    inverse softplus of a log-uniform dt in [1e-3, 1e-1] (Mamba2's
    published initialisation) from a second draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(yardstick.derive(seed, "weights"))
    normal = [(p, s, i) for p, s, i in spec if i[0] == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree, off = {}, 0
    for path, shape, init in normal:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        leaf.mul_(init[1])
        set_path(tree, path, leaf)
        off += n
    uniform = [(p, s, i) for p, s, i in spec if i[0] in ("a_log", "dt_bias")]
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=gen,
                   device=device, dtype=torch.float32)
    off = 0
    for path, shape, init in spec:
        kind = init[0]
        if kind == "normal":
            continue
        if kind == "empty":
            set_path(tree, path, {})
            continue
        if kind in ("ones", "zeros"):
            fill = torch.ones if kind == "ones" else torch.zeros
            set_path(tree, path, fill(shape, device=device, dtype=dtype))
            continue
        n = math.prod(shape)
        x = u[off:off + n].view(shape)
        off += n
        if kind == "a_log":
            leaf = torch.log(1.0 + 15.0 * x)
        else:
            dt = torch.exp(math.log(1e-3) + x * math.log(100.0))
            leaf = dt + torch.log(-torch.expm1(-dt))
        set_path(tree, path, leaf.to(dtype))
    return tree


def leaves_with_path(tree, prefix=""):
    """(path, tensor) pairs with dict keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += leaves_with_path(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def token_nll_sum(logits, labels, vocab: int):
    """Summed next-token negative log-likelihood of ``labels`` under
    ``logits`` (..., V), over the first ``vocab`` columns (the rest is
    padding)."""
    lg = logits[..., :vocab].float()
    return (torch.logsumexp(lg, dim=-1)
            - torch.gather(lg, -1, labels.long()[..., None])[..., 0]).sum()


def rms(x, eps: float = 1e-5):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


class AdamW:
    """AdamW as published (Loshchilov and Hutter), with the global-norm
    clip before it: float32 moments and parameters."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                 grad_clip=1.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, grad_clip
        self.t = 0
        self.m, self.v = {}, {}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """params, grads: {path: f32 tensor}; updates params in place and
        returns the clipped gradient's norm per leaf."""
        self.t += 1
        scale = 1.0
        if self.clip:
            total = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(self.clip / (total + 1e-9), max=1.0)
        norms = {}
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k] * scale
            norms[k] = float(torch.linalg.vector_norm(g))
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.wd * p
            p.sub_(self.lr * upd)
        return norms
