"""Mixture-of-Experts transformer (qwen2-moe-a2.7b, arctic-480b); port of the
JAX package's ``models/moe.py``.

GShard-style capacity dispatch over token groups: each (token, slot) of the
top-k routing takes the next free place of its expert's capacity, in
(token, slot) order, and is dropped when the expert is full. Experts are
stacked on a leading E axis, as in the reference.

 - qwen2-moe: 4 shared (always-on) experts + 60 routed top-4.
 - arctic: 128 routed top-2 + a dense residual FFN in parallel.

The reference writes dispatch and combine as one-hot einsums over
(g, E, capacity) tensors. ``_moe_group`` computes the same function by
index: the kept (token, slot) pairs are copied into their (expert, place)
rows of an (E, capacity, d) buffer, the experts run as batched products,
and each token gathers its k rows back and sums them, weighted by its
gates, in f32. Dispatch is exact; combine adds the same <= k terms in
slot order. ``_moe_group_onehot`` keeps the reference's einsum form as the
plain version the tests hold it against.

``dropless_moe`` is the other layer here, with no capacity: granite-4.0-h's
routed experts (the ``hybrid_moe`` family). It is told which experts it
holds, [first, first + held), routes over all ``n_experts``, and computes
the part of the result its own experts give, dropping no pair; the held
(token, slot) pairs are sorted by expert and run as grouped products.
Padding the capacity path to no drops would run E / k times the rows.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import spans
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.base import ModelConfig

MOE_GROUP = 4096  # the reference's default dispatch group (cfg.moe_group)


def _n_experts_padded(cfg: ModelConfig) -> int:
    return max(cfg.n_experts, cfg.moe_pad_experts)


def init_moe_ffn(normal, cfg: ModelConfig, device):
    E = _n_experts_padded(cfg)
    d, f = cfg.d_model, cfg.d_ff

    def stacked(d_in, d_out):
        return (normal((E, d_in, d_out)) * d_in ** -0.5).to(cfg.dtype)

    p = {"router": L.dense_init(normal, d, E, cfg.dtype, scale=0.02),
         "experts": {"wi": stacked(d, f), "wg": stacked(d, f),
                     "wo": stacked(f, d)}}
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(normal, cfg, d_ff=f * cfg.n_shared_experts)
    if cfg.moe_dense_residual:
        p["dense"] = L.init_mlp(normal, cfg, d_ff=f)
    return p


def _route(p, cfg: ModelConfig, xt):
    """Top-k routing of one group xt (g, d) with capacity. Returns
    (gate_idx (g, k), pos (g, k) place in the expert, keep (g, k), gates
    (g, k) f32 renormalised and zero where dropped, cap, the GShard
    load-balance aux loss). Nothing here waits on the device."""
    g = xt.shape[0]
    E, k = _n_experts_padded(cfg), cfg.top_k
    cap = max(int(cfg.moe_capacity_factor * k * g / E), 1)
    logits = (xt @ p["router"]).float()                          # (g, E)
    if E > cfg.n_experts:  # padding experts are never routed to
        pad = torch.arange(E, device=xt.device) >= cfg.n_experts
        logits = torch.where(pad, L.NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)           # (g, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    # place of each (token, slot) in its expert: the picks of that expert
    # before it in (token, slot) order, tokens first. The running counts
    # are scanned along the innermost axis of an (E, g*k) one-hot, one
    # parallel scan per expert (a scan down the outer axis of (g*k, E)
    # took 3 ms a group on an H100)
    flat = gate_idx.reshape(1, -1)                               # (1, g*k)
    onehot = F.one_hot(flat[0], E).T.contiguous()                # (E, g*k)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = before.gather(0, flat).reshape(g, k)
    keep = pos < cap
    # GShard load balance: the share of (token, slot) picks each expert
    # gets (dropped or not) against its mean router probability
    frac_tokens = onehot.sum(1).float() / g
    aux = E * torch.sum(frac_tokens * probs.mean(0)) * cfg.router_aux_weight
    return gate_idx, pos, keep, gate_vals * keep, cap, aux


def _experts(ex, ex_in):
    """(E, C, d) -> (E, C, d): each expert's swiglu FFN on its rows."""
    hidden = F.silu(torch.bmm(ex_in, ex["wi"])) * torch.bmm(ex_in, ex["wg"])
    return torch.bmm(hidden, ex["wo"])


def _moe_group(p, cfg: ModelConfig, xt):
    """Dispatch one token group by index. xt: (g, d) -> (out (g, d), aux).

    Under tensor parallelism every model rank routes the whole group alike
    (the router is whole, the tokens the same on every rank) and runs the
    experts it holds: under expert parallelism its E / m experts, whose
    places alone it fills (the other (token, slot) pairs go to the spare
    row); under the per-expert fallback every expert on its columns of the
    hidden width. Its combine is then a partial sum, summed over the model
    group; the aux loss comes from the whole routing and is not."""
    g, d = xt.shape
    E, k = _n_experts_padded(cfg), cfg.top_k
    gate_idx, pos, keep, gates, cap, aux = _route(p, cfg, xt)
    ex = p["experts"]
    n_ex = ex["wi"].shape[0]                     # experts this rank runs
    split = tp.size() > 1 and (n_ex != E or ex["wi"].shape[-1] != cfg.d_ff)
    # row of each (token, slot) in a flat (n_ex * cap + 1, d) buffer: its
    # expert's place, or the spare last row when dropped (no boolean
    # indexing, so the host never waits on the device)
    if n_ex == E:
        rows = torch.where(keep, gate_idx * cap + pos, E * cap)  # (g, k)
    else:
        local = gate_idx - tp.rank() * n_ex
        rows = torch.where(keep & (local >= 0) & (local < n_ex),
                           local * cap + pos, n_ex * cap)
    if split:
        xt, gates = tp.copy_to_model(xt), tp.copy_to_model(gates)
    ex_in = xt.new_zeros(n_ex * cap + 1, d)
    ex_in[rows.reshape(-1)] = xt[:, None].expand(g, k, d).reshape(g * k, d)
    ex_out = _experts(ex, ex_in[:-1].reshape(n_ex, cap, d))
    ex_out = F.pad(ex_out.reshape(n_ex * cap, d), (0, 0, 0, 1))  # spare: 0
    out = (ex_out[rows].float() * gates[..., None]).sum(1)       # (g, d)
    if split:
        out = tp.reduce_from_model(out)
    return out.to(xt.dtype), aux


def _moe_group_onehot(p, cfg: ModelConfig, xt):
    """The reference's one-hot einsum dispatch and combine: the plain
    version of ``_moe_group``, O(g * E * cap * d)."""
    E = _n_experts_padded(cfg)
    gate_idx, pos, keep, gates, cap, aux = _route(p, cfg, xt)
    onehot = F.one_hot(gate_idx, E).float()                      # (g, k, E)
    pos_oh = F.one_hot(torch.where(keep, pos, 0), cap).float() \
        * keep[..., None]
    dispatch = torch.einsum("tke,tkc->tec", onehot, pos_oh)
    combine = torch.einsum("tke,tkc,tk->tec", onehot, pos_oh, gates)
    ex_in = torch.einsum("tec,td->ecd", dispatch, xt.float()).to(xt.dtype)
    ex_out = _experts(p["experts"], ex_in)
    out = torch.einsum("tec,ecd->td", combine, ex_out.float())
    return out.to(xt.dtype), aux


def apply_moe_ffn(p, cfg: ModelConfig, x):
    """x: (b, s, d) -> (out, aux_loss). Tokens are dispatched in groups of
    ``cfg.moe_group`` (all t tokens at once when that does not divide t,
    as in decode); aux is the mean over groups.

    Under sequence parallelism ``x`` is this rank's slice: the FFN
    gathers the sequence (routing and the groups are the whole batch's),
    runs as without the mode, and hands back its slice of the output. The
    routing, aux loss included, is then computed alike on every rank, so
    the gathered stream keeps whole gradients (a partial one would need
    the aux loss's gradient divided among the ranks)."""
    if tp.seq_parallel():
        xs = tp.seq_gather(x)
        with tp.whole_sequence():
            out, aux = apply_moe_ffn(p, cfg, xs)
        return tp.seq_slice(out), aux
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    group = cfg.moe_group or MOE_GROUP
    g = group if t % group == 0 else t
    outs, auxs = zip(*(_moe_group(p, cfg, xt[i:i + g])
                       for i in range(0, t, g)))
    out = torch.cat(outs).reshape(b, s, d)
    aux = torch.stack(auxs).mean()
    if "shared" in p:
        out = out + L.apply_mlp(p["shared"], cfg, x,
                                d_ff=cfg.d_ff * cfg.n_shared_experts)
    if "dense" in p:
        out = out + L.apply_mlp(p["dense"], cfg, x)
    return out, aux


# ---------------------------------------------------------------------------
# dropless routed experts (granite-4.0-h)
# ---------------------------------------------------------------------------


def init_held_experts(normal, cfg: ModelConfig):
    """The router over all ``cfg.n_experts`` and the ``cfg.experts_held``
    experts held here (all where 0), each a SwiGLU of width ``cfg.d_ff``
    whose input projection ``w1`` (d, 2 f) gives the gate's columns, then
    the up projection's, and ``w2`` (f, d)."""
    held, d, f = cfg.experts_held or cfg.n_experts, cfg.d_model, cfg.d_ff
    return {"router": L.dense_init(normal, d, cfg.n_experts, cfg.dtype),
            "experts": {
                "w1": (normal((held, d, 2 * f)) * d ** -0.5).to(cfg.dtype),
                "w2": (normal((held, f, d)) * f ** -0.5).to(cfg.dtype)}}


def dropless_moe(p, cfg: ModelConfig, x, first: int = 0):
    """The routed experts of ``x`` (b, s, d) -> f32 (b, s, d): every token's
    top ``cfg.top_k`` of the router's logits over all experts, its gates
    the softmax of those k logits, and the sum over its slots whose expert
    this layer holds, [first, first + held) with held the experts in
    ``p["experts"]``, of gate x expert(x). No pair is dropped; the other
    slots are the absent experts' part, left to the layers that hold them.

    Spans ``moe.route`` (router, top-k, the held pairs sorted by expert,
    their rows gathered), ``moe.experts`` (the grouped products) and
    ``moe.combine`` (the gated rows added into their tokens in f32); while
    spans are on, counters ``moe.pairs_held``, ``moe.pairs_busiest`` and
    ``moe.pairs_dropped``. The host reads the held experts' row counts once
    a call: the grouped products take the rows that exist."""
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    ex = p["experts"]
    held = ex["w1"].shape[0]
    xt = x.reshape(t, d)
    with spans.span("moe.route"):
        logits = (xt @ p["router"]).float()                       # (t, E)
        top, idx = torch.topk(logits, k, dim=-1)                  # (t, k)
        gates = torch.softmax(top, dim=-1)
        local = idx.reshape(-1) - first
        mine = (local >= 0) & (local < held)
        key = torch.where(mine, local, held)         # absent experts last
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=held + 1)[:held]
        rows = counts.tolist()
        n = sum(rows)
        pick = order[:n]
        tok = pick // k
        xs = xt[tok]
        gs = gates.reshape(-1)[pick]
    with spans.span("moe.experts"):
        ys = held_products(ex, xs, counts, rows)
    if spans.on():
        spans.count("moe.pairs_held", n)
        spans.count("moe.pairs_busiest", max(rows))
        # the pairs the router sent to held experts, against the rows
        # the products gave back
        spans.count("moe.pairs_dropped", int(mine.sum()) - ys.shape[0])
    with spans.span("moe.combine"):
        out = torch.zeros(t, d, dtype=torch.float32, device=x.device)
        out.index_add_(0, tok, ys.float().mul_(gs[:, None]))
    return out.reshape(b, s, d)


def held_products(ex, xs, counts, rows):
    """Each held expert's SwiGLU on its rows of ``xs`` (n, d), sorted by
    expert, ``rows`` of each (``counts`` on the device): on a CPU tensor
    the plain version, one expert at a time; on any other device two
    grouped products (``torch._grouped_mm``), which take bf16 alone:
    another dtype raises."""
    if xs.device.type == "cpu":
        return plain_held_products(ex, xs, rows)
    if xs.dtype != torch.bfloat16 or ex["w1"].dtype != torch.bfloat16:
        raise TypeError(f"the grouped expert products take bf16, not "
                        f"{xs.dtype} rows and {ex['w1'].dtype} weights")
    if not xs.shape[0]:
        return xs.new_zeros(0, ex["w2"].shape[2])
    f = ex["w2"].shape[1]
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    h1 = torch._grouped_mm(xs, ex["w1"], offs=offs)
    return torch._grouped_mm(F.silu(h1[:, :f]) * h1[:, f:], ex["w2"],
                             offs=offs)


def plain_held_products(ex, xs, rows):
    """``held_products`` in plain PyTorch: expert e's two products on its
    ``rows[e]`` rows of ``xs``, one expert after another."""
    outs, r0 = [], 0
    f = ex["w2"].shape[1]
    for e, c in enumerate(rows):
        h1 = xs[r0:r0 + c] @ ex["w1"][e]
        outs.append((F.silu(h1[:, :f]) * h1[:, f:]) @ ex["w2"][e])
        r0 += c
    return torch.cat(outs) if outs else xs.new_zeros(0, xs.shape[1])


def init_block(normal, cfg: ModelConfig, device):
    return {"ln1": L.init_norm(cfg, device),
            "attn": L.init_attention(normal, cfg, device),
            "ln2": L.init_norm(cfg, device),
            "moe": init_moe_ffn(normal, cfg, device)}


def apply_block(bp, cfg: ModelConfig, h, *, positions=None, cache=None,
                cache_index=None):
    a, new_cache = L.apply_attention(
        bp["attn"], cfg, L.apply_norm(bp["ln1"], cfg, h),
        positions=positions, cache=cache, cache_index=cache_index)
    h = h + a
    m, aux = apply_moe_ffn(bp["moe"], cfg, L.apply_norm(bp["ln2"], cfg, h))
    return h + m, new_cache, aux


def init(normal, cfg: ModelConfig, device):
    return {
        "embed": L.init_embed(normal, cfg),
        "blocks": T.stack_init(lambda: init_block(normal, cfg, device),
                               cfg.n_layers),
        "final_norm": L.init_norm(cfg, device),
    }


def forward(params, cfg: ModelConfig, tokens, *, positions=None, cache=None,
            cache_index=None):
    """Returns (logits, new cache or None, the summed aux loss)."""
    h = L.embed_tokens(params["embed"], tokens, cfg)
    aux = []
    body = T.remat_wrap(cfg, lambda h, bp, c: apply_block(
        bp, cfg, h, positions=positions, cache=c, cache_index=cache_index))

    def apply(h, bp, c):
        h, nc, a = body(h, bp, c)
        aux.append(a)
        return h, nc

    h, new_cache = T.run_layers(h, params["blocks"], cache, cfg.n_layers,
                                apply)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for a in aux:                                 # the reference's scan order
        total = total + a
    h = L.apply_norm(params["final_norm"], cfg, h)
    return L.unembed(params["embed"], cfg, h), new_cache, total


def loss_fn(params, cfg: ModelConfig, batch):
    logits, _, aux = forward(params, cfg, batch["tokens"])
    return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:], cfg) + aux


init_cache = T.init_cache


def prefill(params, cfg: ModelConfig, tokens, max_seq: Optional[int] = None):
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq or s, tokens.device)
    logits, cache, _ = forward(params, cfg, tokens, cache=cache,
                               cache_index=0)
    return logits, cache


def decode_step(params, cfg: ModelConfig, cache, pos: int, tokens):
    """tokens: (b, 1); pos: int index into the cache."""
    positions = torch.full((1,), int(pos), dtype=torch.int64,
                           device=tokens.device)
    logits, cache, _ = forward(params, cfg, tokens, positions=positions,
                               cache=cache, cache_index=int(pos))
    return logits, cache
