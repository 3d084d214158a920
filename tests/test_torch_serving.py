"""The port's serving engine and launcher (``repro_torch.serving``,
``repro_torch.launch.serve``) against the reference's on reduced olmo-1b,
mamba2-2.7b and zamba2-7b in f32: the reference's weights carried across,
the same prompts, identical greedy tokens. The MoE family is not
batching-invariant (an expert's capacity depends on the batch), so its
greedy tokens are held to the reference engine's in
``tests/test_torch_moe.py`` and only its launcher runs here."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

SERVED = ["olmo-1b", "mamba2-2.7b", "zamba2-7b"]
LAUNCHED = SERVED + ["qwen2-moe-a2.7b"]


@functools.lru_cache(maxsize=None)
def _engines(arch):
    jcfg, cfg = j_reduced(J_ARCHS[arch]), reduced(ARCHS[arch])
    jparams = jreg.init(jax.random.key(0), jcfg)
    params = registry.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return JEngine(jcfg, params=jparams), ServingEngine(cfg, params=params,
                                                        device="cpu")


def _prompts(cfg, n, length, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=length).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", SERVED)
def test_greedy_tokens_match_reference(arch):
    jeng, eng = _engines(arch)
    prompts = _prompts(eng.cfg, 3, 12)
    got = eng.serve_batch([Request(i, p, 6) for i, p in enumerate(prompts)])
    want = jeng.serve_batch([JRequest(i, p, 6)
                             for i, p in enumerate(prompts)])
    for g, w in zip(got, want):
        assert g.rid == w.rid
        assert g.tokens.shape == (6,) and g.tokens.dtype == np.int32
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


@pytest.mark.parametrize("arch", SERVED)
def test_engine_batching_invariance(arch):
    """Greedy decode of a request is identical alone vs inside a batch
    (tests/test_serving.py:65-81)."""
    _, eng = _engines(arch)
    reqs = [Request(i, p, 6) for i, p in enumerate(_prompts(eng.cfg, 3, 12))]
    batched = eng.serve_batch(reqs)
    singles = [eng.serve_batch([r])[0] for r in reqs]
    for b, s in zip(batched, singles):
        assert b.rid == s.rid
        np.testing.assert_array_equal(b.tokens, s.tokens)


def test_per_request_token_budgets():
    _, eng = _engines("mamba2-2.7b")
    p = _prompts(eng.cfg, 2, 8)
    out = eng.serve_batch([Request(7, p[0], 2), Request(9, p[1], 5)])
    assert [c.rid for c in out] == [7, 9]
    assert [len(c.tokens) for c in out] == [2, 5]
    assert all(int(t) < eng.cfg.vocab_size for c in out for t in c.tokens)


def test_mixed_prompt_lengths_raise():
    _, eng = _engines("olmo-1b")
    p = _prompts(eng.cfg, 2, 10)
    with pytest.raises(ValueError, match="share a prompt length"):
        eng.serve_batch([Request(0, p[0], 3), Request(1, p[1][:7], 3)])


def test_engine_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(reduced(ARCHS["mamba2-2.7b"]))


@pytest.mark.parametrize("arch", LAUNCHED)
def test_serve_launcher_on_cpu(arch, capsys):
    toks = launch_serve.main(["--arch", arch, "--reduced", "--requests", "2",
                              "--prompt-len", "8", "--gen", "4",
                              "--device", "cpu"])
    assert toks.shape == (2, 4)
    assert int(toks.max()) < reduced(ARCHS[arch]).vocab_size
    assert "ms/token/request" in capsys.readouterr().out
