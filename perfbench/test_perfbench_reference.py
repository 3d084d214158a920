"""The plain references against the program at the tiny sizes on the CPU,
in float32: the dense model's loss, gradient and AdamW update, and the
Mamba2 model's loss and its served logits (prefill, then decode through
the cache)."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench import harness
from perfbench._testing import REPO, TINY_MODEL
from perfbench.reference import common as C
from perfbench.reference import dense, ssm


def tiny(name):
    c = json.loads((REPO / "perfbench" / "configs" / f"{name}.json")
                   .read_text())
    c["model"].update(TINY_MODEL[c["model"]["family"]])
    return c, harness.model_config(c)


def tokens(vocab, rows, seq, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (rows, seq), generator=g)


def test_dense_loss_and_gradient():
    from repro_torch.core import tree as T
    from repro_torch.models import registry
    c, cfg = tiny("olmo-1b")
    m = c["model"]
    w = C.make_weights(dense.spec(m), 5, torch.device("cpu"), torch.float32)
    x = tokens(m["vocab_size"], 3, 32)
    loss, grads = T.value_and_grad(lambda p, b: registry.loss_fn(p, cfg, b))(
        w, {"tokens": x, "labels": x})
    leaves = {p: v.clone().requires_grad_(True)
              for p, v in C.leaves_with_path(w)}
    tree = {"blocks": {"ln1": {}, "ln2": {}}, "final_norm": {}}
    for p, v in leaves.items():
        C.set_path(tree, p, v)
    s, n = dense.loss_sum(tree, m, x, C.matmul("f32"))
    (s / n).backward()
    assert float(s.detach() / n) == pytest.approx(float(loss), rel=1e-6)
    for p, g in T.leaves_with_path(grads):
        # float32 round-off of sums over 3 x 31 positions, at the leaf's scale
        torch.testing.assert_close(leaves[p].grad, g, rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))


def test_adamw_update():
    from repro_torch.optim import AdamW
    hp = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              grad_clip=1.0)
    g = torch.Generator().manual_seed(1)
    p = {"a": torch.randn(7, 5, generator=g), "b": torch.randn(9,
                                                                generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) * 3 for k, v in p.items()}
             for _ in range(3)]
    prog, state = AdamW(**hp), None
    state = prog.init(p)
    q, ref = dict(p), C.AdamW(**hp)
    mine = {k: v.clone() for k, v in p.items()}
    for gr in grads:
        q, state = prog.update(gr, state, q)
        ref.step(mine, gr)
    for k in p:
        torch.testing.assert_close(mine[k], q[k], rtol=1e-6, atol=1e-7)


def test_ssm_loss():
    from repro_torch.models import registry
    c, cfg = tiny("mamba2-2.7b")
    m = c["model"]
    w = C.make_weights(ssm.spec(m), 6, torch.device("cpu"), torch.float32)
    x = tokens(m["vocab_size"], 2, 48, seed=1)
    with torch.no_grad():
        want = float(registry.loss_fn(w, cfg, {"tokens": x, "labels": x}))
    s, n = ssm.loss_sum(w, m, x, C.matmul("f32"))
    assert s / n == pytest.approx(want, rel=1e-5)


def test_ssm_served_logits():
    """The engine's greedy tokens, and its prefill and decode logits, held
    against the reference's full forward pass over prompt and tokens."""
    from repro_torch.models import registry
    from repro_torch.serving import Request, ServingEngine
    c, cfg = tiny("mamba2-2.7b")
    m = c["model"]
    w = C.make_weights(ssm.spec(m), 7, torch.device("cpu"), torch.float32)
    prompt = tokens(m["vocab_size"], 1, 20, seed=2)[0]
    out = ServingEngine(cfg, params=w, device="cpu").serve_batch(
        [Request(0, prompt.numpy().astype("int32"), 5)])[0]
    served = torch.from_numpy(out.tokens).long()
    ref = ssm.served_logits(w, m, prompt, served, C.matmul("f32"))
    assert torch.equal(ref.argmax(-1), served)
    with torch.no_grad():
        logits, cache = registry.prefill(w, cfg, {"tokens": prompt[None]})
        steps = [logits[0, -1]]
        for t in range(4):
            lg, cache = registry.decode_step(w, cfg, cache, 20 + t,
                                             served[t].view(1, 1))
            steps.append(lg[0, -1])
    got = torch.stack(steps)[:, :m["vocab_size"]]
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
