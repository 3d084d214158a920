"""The port's config registry (``repro_torch.configs``) against the
reference's: ``n_frames_for`` and ``batch_extras`` give the shapes and
dtypes of the reference's ``input_specs`` modality extras for every
(arch, shape) pair, as meta-device tensors; and ports of
``tests/test_configs.py::test_assigned_dims_exact`` and
``::test_vocab_padding_is_mxu_and_tp_aligned`` for the 10 archs."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import input_specs as j_input_specs  # noqa: E402
from repro.configs import n_frames_for as j_n_frames_for  # noqa: E402
from repro_torch.configs import (ARCHS, INPUT_SHAPES, batch_extras,  # noqa: E402
                                 n_frames_for, pairs)

_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# the assigned table, verbatim from tests/test_configs.py
ASSIGNED = {
    "mamba2-2.7b": dict(n_layers=64, d_model=2560, d_ff=0, vocab_size=50280,
                        ssm_state=128, family="ssm"),
    "seamless-m4t-medium": dict(n_layers=12, d_model=1024, n_heads=16,
                                n_kv_heads=16, d_ff=4096, vocab_size=256206,
                                family="audio"),
    "qwen2-moe-a2.7b": dict(n_layers=24, d_model=2048, n_heads=16,
                            n_kv_heads=16, d_ff=1408, vocab_size=151936,
                            n_experts=60, top_k=4, family="moe"),
    "arctic-480b": dict(n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
                        d_ff=4864, vocab_size=32000, n_experts=128, top_k=2,
                        family="moe"),
    "olmo-1b": dict(n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
                    d_ff=8192, vocab_size=50304, family="dense"),
    "qwen2.5-3b": dict(n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
                       d_ff=11008, vocab_size=151936, family="dense"),
    "phi4-mini-3.8b": dict(n_layers=32, d_model=3072, n_heads=24,
                           n_kv_heads=8, d_ff=8192, vocab_size=200064,
                           family="dense"),
    "llama-3.2-vision-90b": dict(n_layers=100, d_model=8192, n_heads=64,
                                 n_kv_heads=8, d_ff=28672,
                                 vocab_size=128256, family="vlm"),
    "zamba2-7b": dict(n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
                      d_ff=14336, vocab_size=32000, ssm_state=64,
                      family="hybrid"),
    "mistral-large-123b": dict(n_layers=88, d_model=12288, n_heads=96,
                               n_kv_heads=8, d_ff=28672, vocab_size=32768,
                               family="dense"),
}


@pytest.mark.parametrize("arch_id,shape_name", list(pairs()))
def test_batch_extras_match_reference_input_specs(arch_id, shape_name):
    cfg, shape = ARCHS[arch_id], INPUT_SHAPES[shape_name]
    want = {k: v for k, v in j_input_specs(J_ARCHS[arch_id], shape).items()
            if k not in ("tokens", "labels", "pos")}
    got = batch_extras(cfg, shape.global_batch, shape.seq_len)
    assert sorted(got) == sorted(want)
    assert sorted(got) == {"vlm": ["image_embeds"],
                           "audio": ["audio_frames"]}.get(cfg.family, [])
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape
        assert jnp.dtype(_DT[t.dtype]) == jnp.dtype(want[k].dtype)


@pytest.mark.parametrize("seq_len", [1, 32, 63, 64, 2048, 4096, 32_768])
def test_n_frames_for_matches_reference(seq_len):
    cfg = ARCHS["seamless-m4t-medium"]
    assert n_frames_for(cfg, seq_len) == j_n_frames_for(
        J_ARCHS["seamless-m4t-medium"], seq_len)
    assert n_frames_for(cfg, 2048) == 512


@pytest.mark.parametrize("arch_id", sorted(ASSIGNED))
def test_assigned_dims_exact(arch_id):
    cfg = ARCHS[arch_id]
    for k, v in ASSIGNED[arch_id].items():
        assert getattr(cfg, k) == v, (arch_id, k, getattr(cfg, k), v)
    assert cfg.source, "every config must cite its source"


def test_vocab_padding_is_mxu_and_tp_aligned():
    assert len(ARCHS) == 10
    for cfg in ARCHS.values():
        assert cfg.vocab_padded % 128 == 0
        assert cfg.vocab_padded % 16 == 0
        assert cfg.vocab_padded >= cfg.vocab_size
        assert cfg.vocab_padded - cfg.vocab_size < 128
