"""Model configuration shared across all architecture families.

One dataclass covers every assigned family (dense / moe / ssm / hybrid /
vlm / audio enc-dec); family-specific fields default to "off". Same fields
and defaults as the JAX package's ``ModelConfig``, plus those of the
port's own ``hybrid_moe`` family (granite-4.0-h: ``layer_types``,
``experts_held``, ``shared_d_ff``, ``ssm_conv_bias``, ``nope`` and the
muP multipliers), which the JAX package does not have; ``dtype`` is a
torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str = "unnamed"
    # dense | moe | ssm | hybrid | hybrid_moe | vlm | audio
    family: str = "dense"
    source: str = ""       # citation for the assigned config

    # core transformer dims
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention details
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0     # 0 -> full causal attention
    # norm: "rmsnorm" | "layernorm" | "nonparametric_ln" (OLMo)
    norm: str = "rmsnorm"
    # mlp: "swiglu" | "gelu"
    mlp: str = "swiglu"
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False
    router_aux_weight: float = 0.01
    moe_capacity_factor: float = 1.25
    moe_group: int = 4096
    moe_pad_experts: int = 0

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_conv_bias: bool = False  # a bias on the causal convolutions
    attn_every: int = 0

    # hybrid_moe (granite-4.0-h): each layer's mixer by type, "mamba" or
    # "attention", each followed by the routed experts and a shared MLP
    layer_types: tuple = ()
    experts_held: int = 0        # routed experts held here; 0 -> all
    shared_d_ff: int = 0         # the shared MLP's width; 0 -> none
    # muP multipliers: embeddings x, residual branches x, logits / scaling;
    # attention_multiplier is the softmax scale (0 -> head_dim^-0.5)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: float = 0.0
    nope: bool = False           # no position embedding (no rotary)

    # VLM
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    d_vision: int = 0

    # audio enc-dec
    n_encoder_layers: int = 0
    n_audio_frames: int = 0
    d_audio: int = 0

    # numerics / performance knobs
    dtype: Any = torch.float32
    remat: bool = False
    remat_policy: str = "full"
    # hand-written CUDA kernels (plain PyTorch on CPU tensors): causal
    # self-attention without a cache dispatches to repro_torch.kernels
    use_flash_kernel: bool = False
    use_ssd_kernel: bool = False
    seq_shard: bool = False

    def __post_init__(self):
        # a configuration file gives the layer types as a JSON list
        object.__setattr__(self, "layer_types", tuple(self.layer_types))

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 128; the loss masks the padding."""
        return round_up(self.vocab_size, 128)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        from repro_torch.models import registry  # local import to avoid cycles
        return registry.param_count(self)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the assigned workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
