"""Hybrid Mamba2 / attention model with routed experts after every mixer:
IBM's granite-4.0-h (Hugging Face model type ``granitemoehybrid``). The
port's own family; the JAX package has none.

Each layer takes a mixer by ``cfg.layer_types[i]``, "mamba" (the Mamba2
mixer of ``models/mamba2.py``, the causal convolutions with a bias under
``cfg.ssm_conv_bias``) or "attention" (GQA with no position embedding
under ``cfg.nope``, softmax scale ``cfg.attention_multiplier``), then an
FFN: the dropless routed experts of ``models/moe.py`` beside a shared
SwiGLU MLP of width ``cfg.shared_d_ff``. With the muP multipliers:

    h = embed(x) * embedding_multiplier
    h = h + residual_multiplier * mixer(norm(h))
    h = h + residual_multiplier * (MoE(norm(h)) + Shared(norm(h)))
    logits = norm(h) @ E^T / logits_scaling        (the head tied)

The layers of each kind are stacked on their own leading axis: ``mamba``
(one per "mamba" layer, in order), ``attention`` (one per "attention"
layer: its input norm ``ln`` and wq, wk, wv, wo) and ``ffn`` (one per
layer: its input norm ``ln``, the router, the held experts and the shared
MLP). The routed experts held are ``cfg.experts_held`` of the router's
``cfg.n_experts``: a chip's share of an expert-parallel deployment, the
absent experts' part of each layer left out (``moe.dropless_moe``).

Scoring only: the loss is the cross-entropy (no router loss), and there
is no cache: ``prefill``, ``decode_step`` and ``init_cache`` raise. Nor
does the family split over a model axis (``registry.check_model_axis``).
"""
from __future__ import annotations

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.base import ModelConfig

KINDS = ("mamba", "attention")


def layer_kinds(cfg: ModelConfig):
    """``cfg.layer_types``, checked: one of ``KINDS`` a layer."""
    kinds = tuple(cfg.layer_types)
    if len(kinds) != cfg.n_layers or not set(kinds) <= set(KINDS):
        raise ValueError(f"{cfg.arch_id}: layer_types {kinds} must give one "
                         f"of {KINDS} for each of {cfg.n_layers} layers")
    return kinds


def init_ffn(normal, cfg: ModelConfig, device):
    p = {"ln": L.init_norm(cfg, device),
         **moe.init_held_experts(normal, cfg)}
    if cfg.shared_d_ff:
        p["shared"] = L.init_mlp(normal, cfg, d_ff=cfg.shared_d_ff)
    return p


def init(normal, cfg: ModelConfig, device):
    kinds = layer_kinds(cfg)
    p = {"embed": L.init_embed(normal, cfg),
         "final_norm": L.init_norm(cfg, device),
         "ffn": T.stack_init(lambda: init_ffn(normal, cfg, device),
                             cfg.n_layers)}
    if "mamba" in kinds:
        p["mamba"] = T.stack_init(
            lambda: M.init_mamba_block(normal, cfg, device),
            kinds.count("mamba"))
    if "attention" in kinds:
        p["attention"] = T.stack_init(
            lambda: {"ln": L.init_norm(cfg, device),
                     **L.init_attention(normal, cfg, device)},
            kinds.count("attention"))
    return p


def apply_ffn(fp, cfg: ModelConfig, h):
    """The residual branch of the FFN, in ``h``'s dtype: the routed
    experts (f32) and the shared MLP, times the residual multiplier."""
    x = L.apply_norm(fp["ln"], cfg, h)
    out = moe.dropless_moe(fp, cfg, x)
    if "shared" in fp:
        out = out + L.apply_mlp(fp["shared"], cfg, x,
                                d_ff=cfg.shared_d_ff).float()
    return (out * cfg.residual_multiplier).to(h.dtype)


def forward(params, cfg: ModelConfig, tokens):
    """Logits (b, s, V) of ``tokens`` (b, s)."""
    kinds = layer_kinds(cfg)
    h = L.embed_tokens(params["embed"], tokens, cfg)
    if cfg.embedding_multiplier != 1.0:
        h = h * cfg.embedding_multiplier
    mixers = {kind: iter(T.unbind_layers(params[kind], kinds.count(kind)))
              for kind in KINDS if kind in kinds}
    ffns = T.unbind_layers(params["ffn"], cfg.n_layers)
    r = cfg.residual_multiplier
    for kind, fp in zip(kinds, ffns):
        mp = next(mixers[kind])
        if kind == "mamba":
            out, _ = M.mamba_mixer(mp, cfg, h)
        else:
            out, _ = L.apply_attention(mp, cfg,
                                       L.apply_norm(mp["ln"], cfg, h))
        h = h + out * r
        h = h + apply_ffn(fp, cfg, h)
    h = L.apply_norm(params["final_norm"], cfg, h)
    if cfg.logits_scaling != 1.0:
        h = h / cfg.logits_scaling
    return L.unembed(params["embed"], cfg, h)


def loss_fn(params, cfg: ModelConfig, batch):
    """The mean next-token cross-entropy; with ``batch["logit_positions"]``
    (b, k) also each row's mean and the logits at those positions, from
    the same pass (``layers.cross_entropy``)."""
    logits = forward(params, cfg, batch["tokens"])
    return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:], cfg,
                           batch.get("logit_positions"))


def _no_cache(*args, **kwargs):
    raise NotImplementedError(
        "hybrid_moe has no cache: the port scores it, it does not serve it")


prefill = decode_step = init_cache = _no_cache
