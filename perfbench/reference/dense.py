"""Plain float32 decoder-only transformer (OLMo, arXiv:2402.00838): a
pre-norm block of causal self-attention with rotary positions (the half
split, theta from the configuration) and a SwiGLU MLP, no biases; the
norm non-parametric LayerNorm or RMSNorm; an untied or tied head over the
vocabulary; the mean next-token cross-entropy. Training runs the loss's
gradient one row at a time, then ``common.AdamW``.

The parameter layout is the program's: ``embed/tok`` (vocabulary rows
padded to a multiple of 128), ``embed/unembed`` unless tied, and every
block leaf stacked on a leading layer axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import common as C


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 128) * 128


def spec(m: dict):
    """[(path, shape, init)] of the weights, in the program's layout."""
    L, d, ff = m["n_layers"], m["d_model"], m["d_ff"]
    hd = m.get("head_dim") or d // m["n_heads"]
    nq, nkv, vp = m["n_heads"] * hd, m["n_kv_heads"] * hd, padded_vocab(m)
    if m.get("mlp", "swiglu") != "swiglu" or m.get("qkv_bias") \
            or m.get("sliding_window"):
        raise NotImplementedError("the dense reference runs SwiGLU, no "
                                  "biases, full causal attention")
    out = [("embed/tok", (vp, d), ("normal", 0.02))]
    if not m.get("tie_embeddings"):
        out.append(("embed/unembed", (d, vp), ("normal", d ** -0.5)))
    for name, shape in (("attn/wq", (d, nq)), ("attn/wk", (d, nkv)),
                        ("attn/wv", (d, nkv)), ("attn/wo", (nq, d)),
                        ("mlp/wi", (d, ff)), ("mlp/wg", (d, ff)),
                        ("mlp/wo", (ff, d))):
        out.append((f"blocks/{name}", (L,) + shape,
                    ("normal", shape[0] ** -0.5)))
    for name in ("blocks/ln1", "blocks/ln2", "final_norm"):
        stack = (L,) if name.startswith("blocks") else ()
        if m["norm"] == "nonparametric_ln":
            out.append((name, None, ("empty",)))
        elif m["norm"] == "rmsnorm":
            out.append((name + "/scale", stack + (d,), ("ones",)))
        else:
            raise NotImplementedError(f"norm {m['norm']!r}")
    return out


def _norm(m, x, scale=None):
    if m["norm"] == "rmsnorm":
        return C.rms(x) * scale
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def _rope(x, theta: float):
    """x (b, s, h, d): the pairs (i, i + d/2) rotated by position."""
    s, d = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device,
                                  dtype=torch.float64) / d)
    ang = torch.arange(s, device=x.device, dtype=torch.float64)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


class _Leaves:
    """Float32 views of the weights: a stacked leaf is unbound once, so
    that its gradient is one stack and not a zero-padded copy a layer."""

    def __init__(self, w):
        self.w, self.stacks = w, {}

    def __call__(self, path, layer=None):
        if layer is None:
            x = self.w
            for k in path.split("/"):
                x = x[k]
            return x.float()
        if path not in self.stacks:
            self.stacks[path] = self(path).unbind(0)
        return self.stacks[path][layer]


def logits(w, m: dict, tokens, mm):
    """Logits (b, s, V) of ``tokens`` (b, s) under weights ``w``."""
    b, s = tokens.shape
    d = m["d_model"]
    hd = m.get("head_dim") or d // m["n_heads"]
    nq, nkv = m["n_heads"], m["n_kv_heads"]
    rms_scale = m["norm"] == "rmsnorm"
    leaf = _Leaves(w)
    h = leaf("embed/tok")[tokens.long()]
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    for i in range(m["n_layers"]):
        x = _norm(m, h, leaf("blocks/ln1/scale", i) if rms_scale
                  else None)
        q = mm(x, leaf("blocks/attn/wq", i)).view(b, s, nq, hd)
        k = mm(x, leaf("blocks/attn/wk", i)).view(b, s, nkv, hd)
        v = mm(x, leaf("blocks/attn/wv", i)).view(b, s, nkv, hd)
        q, k = _rope(q, m.get("rope_theta", 1e4)), _rope(k, m.get(
            "rope_theta", 1e4))
        rep = nq // nkv
        k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
        v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)
        scores = mm(q, k.transpose(-1, -2)) * hd ** -0.5
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        att = mm(p, v).transpose(1, 2).reshape(b, s, nq * hd)
        h = h + mm(att, leaf("blocks/attn/wo", i))
        x = _norm(m, h, leaf("blocks/ln2/scale", i) if rms_scale
                  else None)
        up = F.silu(mm(x, leaf("blocks/mlp/wi", i))) \
            * mm(x, leaf("blocks/mlp/wg", i))
        h = h + mm(up, leaf("blocks/mlp/wo", i))
    h = _norm(m, h, leaf("final_norm/scale") if rms_scale else None)
    head = (leaf("embed/tok").T if m.get("tie_embeddings")
            else leaf("embed/unembed"))
    return mm(h, head)


def loss_sum(w, m: dict, tokens, mm):
    """Summed next-token NLL of rows ``tokens`` and its count."""
    lg = logits(w, m, tokens, mm)
    return (C.token_nll_sum(lg[:, :-1], tokens[:, 1:], m["vocab_size"]),
            tokens.shape[0] * (tokens.shape[1] - 1))


def train_readings(w0, m: dict, batches, hp: dict, mm, rows_per_block=1,
                   fault=None, n_workers=1):
    """Steps of AdamW (hyper-parameters ``hp``) from the weights ``w0``
    over ``batches`` (each (B, s) token rows, labels = tokens), the
    gradient of each step summed one block of rows at a time. Returns
    {"loss": [per step], "first_grad": {leaf: norm of the clipped first
    gradient}, "change": {leaf: norm of params after the steps - w0}}.

    ``fault`` plants one of the faults a training step can have in this
    reference, put in the program's place: "half" (the gradient and loss
    of the first half of the rows alone), "no_exchange" (shard j of the
    flat gradient from worker j's rows alone, ``n_workers`` workers:
    the pool's aggregation left out)."""
    paths = [p for p, x in C.leaves_with_path(w0)]
    params = {p: x.detach().float().clone() for p, x in
              C.leaves_with_path(w0)}
    opt = C.AdamW(**hp)
    out = {"loss": []}

    def tree(ps):
        t = {}
        for p, _, init in spec(m):
            if init[0] == "empty":
                C.set_path(t, p, {})
        for p in paths:
            C.set_path(t, p, ps[p])
        return t

    for step, tokens in enumerate(batches):
        rows = tokens.shape[0]
        used = rows // 2 if fault == "half" else rows
        per = rows // n_workers
        groups = ([range(w * per, (w + 1) * per) for w in range(n_workers)]
                  if fault == "no_exchange" else [range(used)])
        grads_by_group, total, count = [], 0.0, 0
        for rows_g in groups:
            leafs = {p: x.requires_grad_(True) for p, x in params.items()}
            acc = {p: torch.zeros_like(x) for p, x in params.items()}
            g_count = len(rows_g) * (tokens.shape[1] - 1)
            for r0 in range(rows_g.start, rows_g.stop, rows_per_block):
                blk = tokens[r0:min(r0 + rows_per_block, rows_g.stop)]
                s, n = loss_sum(tree(leafs), m, blk, mm)
                gs = torch.autograd.grad(s / g_count, list(leafs.values()))
                for p, g in zip(leafs, gs):
                    acc[p] += g
                total += float(s.detach())
                count += n
                del gs, s
            for x in params.values():
                x.requires_grad_(False)
            grads_by_group.append(acc)
        if fault == "no_exchange":
            grads = _own_shards(grads_by_group, paths)
        else:
            grads = grads_by_group[0]
        del grads_by_group
        out["loss"].append(total / count)
        norms = opt.step(params, grads)
        if step == 0:
            out["first_grad"] = norms
        del grads
    out["change"] = {p: float(torch.linalg.vector_norm(
        params[p] - x.float())) for p, x in C.leaves_with_path(w0)}
    return out


def _own_shards(grads, paths):
    """The flat gradient (leaves in sorted-path order) split in as many
    equal shards as workers, shard j taken from worker j's gradient."""
    n = len(grads)
    flats = [torch.cat([g[p].reshape(-1) for p in paths]) for g in grads]
    size = flats[0].numel()
    k = -(-size // n)
    joined = torch.cat([flats[j][j * k:(j + 1) * k] for j in range(n)])
    out, off = {}, 0
    for p in paths:
        x = grads[0][p]
        out[p] = joined[off:off + x.numel()].view_as(x)
        off += x.numel()
    return out
