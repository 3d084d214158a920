"""The CPU tests' tiny sizes of the configurations and mixes added after
``_testing.py``'s tables (which ``tiny_root`` reads by family and by
loop), and the cells whose fp8 control separates only at full size in
test_perfbench_harness.py."""
from perfbench import _testing

# granite-4.0-h-small's pattern, cut to six layers (m m a m m a), d 256,
# 8 experts of which 4 held, top 3; wide enough a vocabulary that the
# logits spread as at full size, relative to their scale
_testing.TINY_MODEL.setdefault("hybrid_moe", dict(
    n_layers=6, d_model=256, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab_size=2048, ssm_state=16, ssm_headdim=32, ssm_chunk=16,
    n_experts=8, experts_held=4, top_k=3, shared_d_ff=128,
    layer_types=["mamba", "mamba", "attention", "mamba", "mamba",
                 "attention"], attention_multiplier=1 / 64,
    dtype="float32"))
_testing.TINY_TRAFFIC.setdefault("score_logits", dict(seq=32, batch=4))

# at the tiny sizes the serve loop's mix replaces every serve mix's
# lengths, so prefill-long runs the serve cell's tiny mix, whose fp8
# control moves a served token's logit by less than the full-size limit:
# added to test_perfbench_harness.py's SEPARATED_ONLY, for the same reason
# as the serve cell there
SEPARATED_ONLY = {"mamba2-2.7b.prefill-long"}
HARNESS_TESTS = "test_perfbench_harness"


def pytest_collection_modifyitems(items):
    for item in items:
        module = getattr(item, "module", None)
        if getattr(module, "__name__", "").rpartition(".")[2] \
                == HARNESS_TESTS:
            module.SEPARATED_ONLY |= SEPARATED_ONLY
