"""Plain float32 granite-4.0-h (IBM's GraniteMoeHybrid): each layer a
mixer by ``layer_types``, a Mamba2 block or causal GQA attention with no
position embedding, then routed experts beside a shared SwiGLU MLP, with
the muP multipliers:

    h = embed(x) * embedding_multiplier
    h = h + residual_multiplier * mixer(rms(h) * ln)
    h = h + residual_multiplier * (MoE(b) + Shared(b)),  b = rms(h) * ln
    logits = (rms(h) * final_norm) @ E^T / logits_scaling   (tied head)

Mamba2 mixer: z, x, B, C (one group) and dt from the input projections,
the causal depthwise convolutions with their biases and SiLU, the SSD
layer in its quadratic form (``ssm.ssd``, the paper's minimal form,
imported), the gated RMSNorm of y * silu(z), the output projection.
Attention: q (n_heads), k, v (n_kv_heads) of head_dim, a plain causal
softmax of q k^T times ``attention_multiplier``, the output projection.
Router: the top ``top_k`` of its f32 logits over all ``n_experts``, gates
the softmax of those k logits. Expert e: (silu(b W1_e[:, :f]) * b W1_e[:,
f:]) W2_e, each held expert run on its own tokens; the layer holds
experts [first, first + held), ``experts_held`` of them, and the slots of
the others add nothing (a chip's share of an expert-parallel deployment).

No chunking, no carried state, no cache, no kernel, no TF32; rows in
blocks, so that it fits on the card beside the weights alone. The
parameter layout is the program's (``repro_torch.models.hybrid_moe``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import common as C
from perfbench.reference import ssm

KINDS = ("mamba", "attention")
# the std of the published convolution's bias initialisation,
# U(-1/sqrt(W), 1/sqrt(W)) at W = 4
CONV_BIAS_STD = 0.5 / 3 ** 0.5


def kinds(m: dict):
    return list(m["layer_types"])


def held(m: dict) -> int:
    return m.get("experts_held") or m["n_experts"]


def spec(m: dict):
    """[(path, shape, init)] of the weights, in the program's layout."""
    ks = kinds(m)
    d, L, f, fs = m["d_model"], m["n_layers"], m["d_ff"], m["shared_d_ff"]
    hd = m.get("head_dim") or d // m["n_heads"]
    nq, nkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    if len(ks) != L or set(ks) - set(KINDS) or not m.get("ssm_conv_bias"):
        raise NotImplementedError("the hybrid_moe reference takes one of "
                                  f"{KINDS} a layer, conv biases on")
    n_m, n_a, W = ks.count("mamba"), ks.count("attention"), \
        m.get("ssm_conv_width", 4)
    di, n = ssm.dims(m)[1:3]
    out = [(p, s, i) for p, s, i in ssm.spec(dict(m, n_layers=1))
           if not p.startswith("blocks/")]
    out += [("mamba/" + p[len("blocks/"):], (n_m,) + s[1:], i)
            for p, s, i in ssm.spec(dict(m, n_layers=1))
            if p.startswith("blocks/")]
    out += [("mamba/conv_x_bias", (n_m, di), ("normal", CONV_BIAS_STD)),
            ("mamba/conv_BC_bias", (n_m, 2 * n), ("normal", CONV_BIAS_STD))]
    out += [(f"attention/{name}", (n_a,) + shape, ("normal", shape[0] ** -0.5))
            for name, shape in (("wq", (d, nq)), ("wk", (d, nkv)),
                                ("wv", (d, nkv)), ("wo", (nq, d)))]
    out.append(("attention/ln/scale", (n_a, d), ("ones",)))
    e = held(m)
    out += [(f"ffn/{name}", (L,) + shape, ("normal", scale))
            for name, shape, scale in (
                ("router", (d, m["n_experts"]), d ** -0.5),
                ("experts/w1", (e, d, 2 * f), d ** -0.5),
                ("experts/w2", (e, f, d), f ** -0.5),
                ("shared/wi", (d, fs), d ** -0.5),
                ("shared/wg", (d, fs), d ** -0.5),
                ("shared/wo", (fs, d), fs ** -0.5))]
    out.append(("ffn/ln/scale", (L, d), ("ones",)))
    return out


def layer(tree, i: int):
    """Layer i of a stacked tree, every leaf in float32."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i].float()


def mamba_mixer(p, m: dict, h, mm):
    """The Mamba2 mixer of the stream h (b, s, d), without the residual."""
    d, di, n, hp, nh = ssm.dims(m)
    b, s = h.shape[:2]
    hn = C.rms(h) * p["ln"]["scale"]
    z = mm(hn, p["wz"])
    x = F.silu(ssm._conv(mm(hn, p["wx"]), p["conv_x"]) + p["conv_x_bias"])
    bc = F.silu(ssm._conv(torch.cat([mm(hn, p["wB"]), mm(hn, p["wC"])], -1),
                          p["conv_BC"]) + p["conv_BC_bias"])
    dt = F.softplus(mm(hn, p["wdt"]) + p["dt_bias"])
    y = ssm.ssd(x.view(b, s, nh, hp), dt, -torch.exp(p["A_log"]),
                bc[..., :n], bc[..., n:], p["D"], mm).reshape(b, s, di)
    return mm(C.rms(y * F.silu(z)) * p["gate_ln"]["scale"], p["wo"])


def attention(p, m: dict, h, mm):
    """Causal GQA attention of the stream h (b, s, d), no position
    embedding, softmax scale ``attention_multiplier``."""
    b, s, d = h.shape
    hd = m.get("head_dim") or d // m["n_heads"]
    nq, nkv = m["n_heads"], m["n_kv_heads"]
    x = C.rms(h) * p["ln"]["scale"]
    q = mm(x, p["wq"]).view(b, s, nq, hd).transpose(1, 2)
    k = mm(x, p["wk"]).view(b, s, nkv, hd).repeat_interleave(
        nq // nkv, dim=2).transpose(1, 2)
    v = mm(x, p["wv"]).view(b, s, nkv, hd).repeat_interleave(
        nq // nkv, dim=2).transpose(1, 2)
    scores = mm(q, k.transpose(-1, -2)) * m["attention_multiplier"]
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    return mm(mm(probs, v).transpose(1, 2).reshape(b, s, nq * hd), p["wo"])


def routed(p, m: dict, x, mm, first: int = 0):
    """The routed experts' part of the FFN of x (t, d): each held expert
    [first, first + held) on the tokens whose top-k holds it, weighted by
    its gate."""
    f = m["d_ff"]
    top, idx = torch.topk(mm(x, p["router"]), m["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(x)
    for e in range(p["experts"]["w1"].shape[0]):
        tok, slot = torch.nonzero(idx == first + e, as_tuple=True)
        if not tok.numel():
            continue
        up = mm(x[tok], p["experts"]["w1"][e])
        y = mm(F.silu(up[:, :f]) * up[:, f:], p["experts"]["w2"][e])
        out.index_add_(0, tok, gates[tok, slot, None] * y)
    return out


def shared(p, x, mm):
    return mm(F.silu(mm(x, p["wi"])) * mm(x, p["wg"]), p["wo"])


def ffn(p, m: dict, h, mm, first: int = 0):
    """The FFN's residual branch (before the multiplier) of h (b, s, d)."""
    x = (C.rms(h) * p["ln"]["scale"]).reshape(-1, h.shape[-1])
    return (routed(p, m, x, mm, first) + shared(p["shared"], x, mm)).view(
        h.shape)


def hidden(w, m: dict, tokens, mm):
    """The final normed stream (b, s, d) of ``tokens`` (b, s), divided by
    ``logits_scaling``."""
    h = w["embed"]["tok"][tokens.long()].float() * m["embedding_multiplier"]
    r = m["residual_multiplier"]
    at = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(kinds(m)):
        p = layer(w[kind], at[kind])
        at[kind] += 1
        mix = mamba_mixer if kind == "mamba" else attention
        h = h + r * mix(p, m, h, mm)
        del p
        h = h + r * ffn(layer(w["ffn"], i), m, h, mm)
    return C.rms(h) * w["final_norm"]["scale"].float() / m["logits_scaling"]


def head(w, m: dict, hid, mm):
    return mm(hid, w["embed"]["tok"].float().T)[..., :m["vocab_size"]]


@torch.no_grad()
def loss_sum(w, m: dict, tokens, mm, rows_per_block: int = 1):
    """Summed next-token NLL of the rows ``tokens`` and its count."""
    total, _ = _rows(w, m, tokens, None, mm, rows_per_block)
    return float(total.sum()), tokens.shape[0] * (tokens.shape[1] - 1)


@torch.no_grad()
def sampled(w, m: dict, tokens, positions, mm, rows_per_block: int = 1):
    """Each row's mean next-token NLL, (b,) float64, and the logits (b, k,
    vocab) at ``positions`` (b, k) of the rows ``tokens`` (b, s)."""
    sums, picked = _rows(w, m, tokens, positions, mm, rows_per_block)
    return sums / (tokens.shape[1] - 1), picked


def _rows(w, m, tokens, positions, mm, rows_per_block):
    C.no_tf32()
    sums, picked = [], []
    for r0 in range(0, tokens.shape[0], rows_per_block):
        t = tokens[r0:r0 + rows_per_block]
        lg = head(w, m, hidden(w, m, t, mm)[:, :-1], mm)
        lg_f = lg.float()
        nll = (torch.logsumexp(lg_f, dim=-1) - torch.gather(
            lg_f, -1, t[:, 1:].long()[..., None])[..., 0])
        sums.append(nll.double().sum(-1))
        if positions is not None:
            rows = torch.arange(t.shape[0], device=t.device)[:, None]
            picked.append(lg[rows, positions[r0:r0 + rows_per_block].long()])
        del lg, lg_f
    return torch.cat(sums), (torch.cat(picked) if picked else None)
