"""The port's serving engine and launcher (``repro_torch.serving``,
``repro_torch.launch.serve``) against the reference's on reduced olmo-1b,
mamba2-2.7b, zamba2-7b, llama-3.2-vision-90b and seamless-m4t-medium in
f32: the reference's weights carried across, the same prompts, identical
greedy tokens (both engines feed the vlm and audio models zero modality
stubs; the launcher feeds them ``reduced_batch``'s embeddings, as the
reference's launcher does). The MoE family is not
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
from repro_torch.configs import ARCHS, reduced, reduced_batch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving.engine import modality_stubs  # noqa: E402

SERVED = ["olmo-1b", "mamba2-2.7b", "zamba2-7b", "llama-3.2-vision-90b",
          "seamless-m4t-medium"]
LAUNCHED = SERVED + ["qwen2-moe-a2.7b"]


@functools.lru_cache(maxsize=None)
def _engines(arch):
    jcfg, cfg = j_reduced(J_ARCHS[arch]), reduced(ARCHS[arch])
    jparams = jreg.init(jax.random.key(0), jcfg)
    if jcfg.family == "vlm":        # open the cross layers' tanh gates
        for g in ("gate_attn", "gate_mlp"):
            jparams["cross"][g] = jax.numpy.full_like(jparams["cross"][g],
                                                      0.5)
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


@pytest.mark.parametrize("arch,key", [("llama-3.2-vision-90b", "image_embeds"),
                                      ("seamless-m4t-medium", "audio_frames")])
def test_serve_prefills_on_reduced_batch_modality_inputs(arch, key,
                                                         monkeypatch):
    """The launcher hands prefill reduced_batch's image / audio embeddings,
    as the reference's serve() does, not the engine's zero stubs."""
    seen = []
    real = registry.prefill

    def spy(params, cfg, batch, max_seq=None):
        seen.append({k: v.clone() for k, v in batch.items()})
        return real(params, cfg, batch, max_seq=max_seq)
    monkeypatch.setattr(registry, "prefill", spy)
    cfg = reduced(ARCHS[arch])
    toks, _, _ = launch_serve.serve(cfg, n_requests=2, prompt_len=8, gen=3,
                                    seed=4, device="cpu")
    assert toks.shape == (2, 3)
    want = reduced_batch(cfg, 2, 8, seed=4)
    assert len(seen) == 1
    got = seen[0][key]
    assert bool(got.abs().sum() > 0)
    np.testing.assert_array_equal(got.float().numpy(), want[key])
    np.testing.assert_array_equal(seen[0]["tokens"].numpy(), want["tokens"])


@pytest.mark.parametrize("arch", LAUNCHED)
def test_serve_launcher_tokens_equal_engine(arch, monkeypatch):
    """The launcher's own prefill / decode loop gives exactly the engine's
    greedy tokens on the same weights (both draw them from registry.init's
    seed) and reduced_batch's prompts. For vlm and audio the launcher is
    handed the engine's zero stubs in place of reduced_batch's embeddings,
    so that both runs see the same inputs."""
    cfg = reduced(ARCHS[arch])
    n, plen, gen, seed = 2, 8, 5, 3

    def zero_extras(cfg, n, plen, seed=0):
        batch = reduced_batch(cfg, n, plen, seed=seed)
        for k, v in modality_stubs(cfg, n, "cpu").items():
            batch[k] = np.zeros(tuple(v.shape), np.float32)
        return batch
    monkeypatch.setattr(launch_serve, "reduced_batch", zero_extras)
    toks, _, _ = launch_serve.serve(cfg, n_requests=n, prompt_len=plen,
                                    gen=gen, seed=seed, device="cpu")
    eng = ServingEngine(cfg, seed=seed, device="cpu")
    prompts = reduced_batch(cfg, n, plen, seed=seed)["tokens"]
    want = eng.serve_batch([Request(i, p, gen) for i, p in enumerate(prompts)])
    assert toks.shape == (n, gen) and toks.dtype == np.int32
    np.testing.assert_array_equal(toks, np.stack([c.tokens for c in want]))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_replayable_only_for_ssm_on_cuda_without_model_axis(
        arch, monkeypatch):
    """Only the ssm family's decode step is replayed as a captured CUDA
    graph, and only on CUDA at tp.size() == 1; every other decode keeps the
    eager loop."""
    from repro_torch.distributed import tensor_parallel as tp
    cfg = ARCHS[arch]
    assert not registry.decode_replayable(cfg, "cpu")
    assert not registry.decode_replayable(cfg, torch.device("cpu"))
    assert registry.decode_replayable(cfg, "cuda") == (cfg.family == "ssm")
    monkeypatch.setattr(tp, "size", lambda: 2)
    assert not registry.decode_replayable(cfg, "cuda")


def _decode_counts():
    from repro_torch.core import spans
    return [(c.name, c.value) for c in spans.counted()
            if c.name.startswith("serve.decode_")]


def test_cpu_engine_counts_every_decode_step_eager():
    from repro_torch.core import spans
    _, eng = _engines("mamba2-2.7b")
    spans.clear()
    with spans.recording():
        eng.serve_batch([Request(i, p, 6) for i, p in
                         enumerate(_prompts(eng.cfg, 3, 12))])
        eng.serve_batch([Request(0, _prompts(eng.cfg, 1, 8)[0], 1)])
    assert _decode_counts() == [("serve.decode_replayed", 0),
                                ("serve.decode_eager", 5),
                                ("serve.decode_replayed", 0),
                                ("serve.decode_eager", 0)]
    assert eng.graphs == {}
    spans.clear()


def test_decode_counters_record_nothing_when_spans_are_off():
    from repro_torch.core import spans
    _, eng = _engines("mamba2-2.7b")
    spans.clear()
    eng.serve_batch([Request(i, p, 4) for i, p in
                     enumerate(_prompts(eng.cfg, 2, 10))])
    assert _decode_counts() == [] and spans.counted() == []
