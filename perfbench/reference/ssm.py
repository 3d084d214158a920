"""Plain float32 Mamba2 language model (arXiv:2405.21060): each block an
RMSNorm, the input projections z, x, B, C (one group) and dt, a causal
depthwise convolution with SiLU over x and over B, C, the SSD layer in
its quadratic (masked attention) form over the whole sequence, the gated
RMSNorm of y * silu(z) and the output projection, added to the stream;
then the final RMSNorm and the head tied to the embedding.

The SSD layer is the paper's minimal form: with a_t = dt_t A,
segsum(i, j) = a_{j+1} + ... + a_i summed along a masked cumulative sum
(so that no two long sums are subtracted),
y_i = sum_{j <= i} (C_i . B_j) exp(segsum(i, j)) dt_j x_j + D x_i.
No chunking, no carried state, no cache.

Departure from the published model, shared with the program: the
convolutions have no bias. The parameter layout is the program's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import common as C

HEAD_GROUP = 16     # heads whose (s, s) decay matrices are held at once


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 128) * 128


def dims(m: dict):
    d = m["d_model"]
    di = m["ssm_expand"] * d
    return d, di, m["ssm_state"], m["ssm_headdim"], di // m["ssm_headdim"]


def spec(m: dict):
    d, di, n, p, nh = dims(m)
    L, W = m["n_layers"], m.get("ssm_conv_width", 4)
    if not m.get("tie_embeddings"):
        raise NotImplementedError("the ssm reference ties the head")
    out = [("embed/tok", (padded_vocab(m), d), ("normal", 0.02))]
    for name, shape, init in (
            ("A_log", (nh,), ("a_log",)), ("D", (nh,), ("ones",)),
            ("conv_BC", (W, 2 * n), ("normal", W ** -0.5)),
            ("conv_x", (W, di), ("normal", W ** -0.5)),
            ("dt_bias", (nh,), ("dt_bias",)),
            ("gate_ln/scale", (di,), ("ones",)),
            ("ln/scale", (d,), ("ones",)),
            ("wB", (d, n), ("normal", d ** -0.5)),
            ("wC", (d, n), ("normal", d ** -0.5)),
            ("wdt", (d, nh), ("normal", d ** -0.5)),
            ("wo", (di, d), ("normal", di ** -0.5)),
            ("wx", (d, di), ("normal", d ** -0.5)),
            ("wz", (d, di), ("normal", d ** -0.5))):
        out.append((f"blocks/{name}", (L,) + shape, init))
    out.append(("final_norm/scale", (d,), ("ones",)))
    return out


def _conv(x, w):
    """Causal depthwise convolution: out_t = sum_k w_k x_{t - W + 1 + k}."""
    W, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(w[k] * xp[:, k:k + s] for k in range(W))


def _segsum(a):
    """a (..., s) -> (..., s, s): sum of a over (j, i] at [i, j], -inf
    above the diagonal."""
    s = a.shape[-1]
    x = a[..., :, None].expand(*a.shape, s)
    ones = torch.ones(s, s, dtype=torch.bool, device=a.device)
    x = torch.cumsum(x.masked_fill(~ones.tril(-1), 0.0), dim=-2)
    return x.masked_fill(~ones.tril(0), float("-inf"))


def ssd(x, dt, A, B, Cm, D, mm):
    """x (b, s, h, p), dt (b, s, h), A (h,), B, C (b, s, n), D (h,)."""
    b, s, h, p = x.shape
    cb = mm(Cm, B.transpose(1, 2))                       # (b, s, s)
    y = torch.empty_like(x)
    xdt = x * dt[..., None]
    for h0 in range(0, h, HEAD_GROUP):
        hs = slice(h0, min(h0 + HEAD_GROUP, h))
        a = (dt[:, :, hs] * A[hs]).transpose(1, 2)       # (b, g, s)
        decay = torch.exp(_segsum(a))                    # (b, g, s, s)
        y[:, :, hs] = mm(cb[:, None] * decay,
                         xdt[:, :, hs].transpose(1, 2)).transpose(1, 2)
        del decay
    return y + D[:, None] * x


def hidden(w, m: dict, tokens, mm):
    """The final normed stream (b, s, d) of ``tokens`` (b, s)."""
    d, di, n, p, nh = dims(m)
    b, s = tokens.shape
    h = w["embed"]["tok"][tokens.long()].float()
    blk = w["blocks"]
    for i in range(m["n_layers"]):
        def leaf(name):
            x = blk
            for k in name.split("/"):
                x = x[k]
            return x[i].float()
        hn = C.rms(h) * leaf("ln/scale")
        z = mm(hn, leaf("wz"))
        x = F.silu(_conv(mm(hn, leaf("wx")), leaf("conv_x")))
        bc = F.silu(_conv(torch.cat([mm(hn, leaf("wB")), mm(hn, leaf("wC"))],
                                    -1), leaf("conv_BC")))
        dt = F.softplus(mm(hn, leaf("wdt")) + leaf("dt_bias"))
        A = -torch.exp(leaf("A_log"))
        y = ssd(x.view(b, s, nh, p), dt, A, bc[..., :n], bc[..., n:],
                leaf("D"), mm).reshape(b, s, di)
        y = C.rms(y * F.silu(z)) * leaf("gate_ln/scale")
        h = h + mm(y, leaf("wo"))
    return C.rms(h) * w["final_norm"]["scale"].float()


def head(w, m: dict, hid, mm):
    return mm(hid, w["embed"]["tok"].float().T)


@torch.no_grad()
def loss_sum(w, m: dict, tokens, mm, rows_per_block: int = 1):
    """Summed next-token NLL of the rows ``tokens`` and its count."""
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for r0 in range(0, tokens.shape[0], rows_per_block):
        t = tokens[r0:r0 + rows_per_block]
        lg = head(w, m, hidden(w, m, t, mm)[:, :-1], mm)
        total += C.token_nll_sum(lg, t[:, 1:], m["vocab_size"]).double()
        del lg
    return float(total), tokens.shape[0] * (tokens.shape[1] - 1)


@torch.no_grad()
def served_logits(w, m: dict, prompt, served, mm):
    """Logits (len(served), vocab) of the positions that chose each of the
    ``served`` tokens after ``prompt`` (1-D token tensors): the full
    forward pass over the prompt and the served tokens but the last."""
    seq = torch.cat([prompt, served[:-1]])[None]
    hid = hidden(w, m, seq, mm)[0, prompt.numel() - 1:]
    return head(w, m, hid, mm)[:, :m["vocab_size"]]
