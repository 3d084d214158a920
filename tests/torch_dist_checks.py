"""Multi-process payload for the port's collective tests (the counterpart
of ``tests/spmd_checks.py``): each rank is one process of a gloo group on
the CPU.

    python tests/torch_dist_checks.py <suite> <rank> <world> <workdir>

``run_world`` starts every rank of a suite, waits for all of them under
one deadline, kills them all on a timeout or a failure, and returns; the
ranks write their results into ``workdir`` as npz files, and the test
files hold them against the reference in their own process. The ranks
import torch and the port only.
"""
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(suite: str, world: int, workdir: str, timeout: float = 300.0):
    """Run ``suite`` on ``world`` ranks; raise with every rank's output if
    any rank fails or the deadline passes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(workdir, f"{suite}_rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(rank),
             str(world), workdir], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=ROOT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"timed out after {timeout} s"
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is None and any(p.returncode for p in procs):
        failed = f"exit codes {[p.returncode for p in procs]}"
    text = []
    for rank, log in enumerate(logs):
        log.seek(0)
        text.append(f"--- rank {rank} ---\n{log.read()[-4000:]}")
        log.close()
    if failed:
        raise RuntimeError(f"{suite} on {world} ranks: {failed}\n"
                           + "\n".join(text))


def load(workdir: str, name: str):
    with np.load(os.path.join(workdir, f"{name}.npz")) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def make_problem(seed=0):
    """tests/spmd_checks.py::make_problem, as numpy arrays."""
    rng = np.random.RandomState(seed)
    params = {"w1": (rng.randn(6, 16) * 0.3).astype(np.float32),
              "w2": (rng.randn(16, 3) * 0.3).astype(np.float32)}
    batch = {"x": rng.randn(32, 6).astype(np.float32),
             "y": rng.randn(32, 3).astype(np.float32)}
    return params, batch


def toy_loss(params, batch):
    import torch
    pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return torch.mean((pred - batch["y"]) ** 2)


def _rows(batch, i, n):
    k = next(iter(batch.values())).shape[0] // n
    return {key: v[i * k:(i + 1) * k] for key, v in batch.items()}


def _save(workdir, name, rank, arrays):
    np.savez(os.path.join(workdir, f"{name}_rank{rank}.npz"), **arrays)


def suite_hier_sync(rank, world, workdir):
    """The four checks of tests/spmd_checks.py on 8 ranks."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import tree as T
    from repro_torch.core.elastic import ElasticRunner
    from repro_torch.core.hier_sync import make_sync_grad_fn, sync_grads
    from repro_torch.launch.mesh import data_index
    from repro_torch.optim import AdamW

    params_np, batch_np = make_problem()
    params = T.from_numpy(params_np, "cpu")
    batch = T.from_numpy(batch_np, "cpu")
    meshes = {"pod2_data4": init_device_mesh("cpu", (2, 4),
                                             mesh_dim_names=("pod", "data")),
              "data8": init_device_mesh("cpu", (8,),
                                        mesh_dim_names=("data",))}
    out = {}
    for name, mesh in meshes.items():
        strategies = ["allreduce", "hier", "ps"]
        if "pod" in mesh.mesh_dim_names:
            strategies += ["hier2", "hier2_q"]
        local = _rows(batch, data_index(mesh), world)
        for strat in strategies:
            loss, grads = make_sync_grad_fn(toy_loss, mesh, strat)(params,
                                                                   local)
            out[f"{name}/{strat}/loss"] = loss.numpy()
            for k, g in grads.items():
                out[f"{name}/{strat}/{k}"] = g.numpy()

    # sync_property: awkward leaf shapes, one row of each leaf a rank
    mesh = meshes["data8"]
    group = mesh.get_group("data")
    rng = np.random.RandomState(1)
    for trial in range(5):
        shapes = [tuple(rng.randint(1, 9) for _ in range(rng.randint(1, 4)))
                  for _ in range(4)]
        tree = {f"p{i}": rng.randn(8, *s).astype(np.float32)
                for i, s in enumerate(shapes)}
        mine = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in tree.items()}
        synced = sync_grads(mine, "hier", data_group=group, n_data=8)
        for k, v in synced.items():
            out[f"property/{trial}/{k}"] = v.numpy()
            out[f"property/{trial}/{k}/input"] = tree[k]

    # elastic: a fleet of [4, 4, 8, 8, 2, 8] against a fixed 8
    opt = AdamW(lr=0.05, weight_decay=0.0, grad_clip=0.0)

    def builder(mesh):
        f = make_sync_grad_fn(toy_loss, mesh, "hier")

        def step(params, opt_state, batch):
            loss, grads = f(params, batch)
            params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, loss
        return step

    def run(schedule):
        r = ElasticRunner(builder, params, opt.init(params),
                          n_workers=schedule[0], device_type="cpu")
        losses = []
        for n in schedule:
            r.rescale(n)
            loss = r.train_step(batch)
            losses.append(float("nan") if loss is None else float(loss))
        return np.array(losses), r.rescale_events

    a, events = run([4, 4, 8, 8, 2, 8])
    b, _ = run([8] * 6)
    out["elastic/rescaled"] = a
    out["elastic/fixed8"] = b
    out["elastic/events"] = np.array(events)
    _save(workdir, "hier_sync", rank, out)


# the reference's 40-step run: tests/test_torch_train.py; its moments and
# params are held after the first TRAIN_SHORT steps
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SHORT = 40, 8, 128, 10
# the hybrid family's ZeRO-3 run (its shared block is gathered at the
# start of a step, its remainder layers through the layer hook)
HYBRID_ARCH = "zamba2-7b"


# ZeRO-3 runs split every leaf of this many elements or more (the
# reference's 2**20 splits none of reduced olmo-1b's)
FSDP_MIN_SIZE = 2 ** 12


def _run_steps(cfg, mesh, strategy, params, n_steps, out, key, fsdp=False,
               snap=None):
    """``n_steps`` of make_train_step(strategy, fsdp) on ``mesh`` with
    launch/train.py's 40-step optimizer and data; into ``out`` under
    ``key``: the losses and, after ``snap`` steps (default all), this
    rank's moments, the gathered moments, the full params and the params
    this rank holds."""
    from repro_torch.core import tree as T
    from repro_torch.data import DataConfig, ShardedLoader, TokenDataset
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import AdamW, warmup_cosine
    opt = AdamW(lr=3e-4, schedule=warmup_cosine(2, TRAIN_STEPS))
    steps_mod.FSDP_MIN_SIZE = FSDP_MIN_SIZE
    step = steps_mod.make_train_step(cfg, mesh, strategy=strategy,
                                     optimizer=opt, fsdp=fsdp)
    params = step.shard_params(params)
    state = step.init_opt_state(params)
    loader = ShardedLoader(TokenDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ)))
    losses = []
    for i in range(n_steps):
        b = T.from_numpy(step.local_batch(loader.next_batch(TRAIN_BATCH)),
                         "cpu")
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
        if i + 1 != (snap or n_steps):
            continue
        full = step.gather_opt_state(state)
        for name, tree in (("mu", state.mu), ("full_mu", full.mu),
                           ("full_nu", full.nu),
                           ("params", step.gather_params(params)),
                           ("held", params)):
            for path, x in T.leaves_with_path(tree):
                out[f"{key}/{name}/{path}"] = x.numpy()
    out[f"{key}/curve"] = np.array(losses)


def suite_train(rank, world, workdir):
    """launch/train.py::train on 4 ranks from the reference's weights, per
    strategy; ten ``hier`` steps on (data 4), once more with a clip by
    each rank's own shard norm (what the group sum prevents); ten
    ``hier`` and ``hier1`` steps on (pod 2, data 2). ZeRO-3 (``fsdp``):
    40 steps on (data 4) per strategy, under ``hier`` with remat "full"
    and "dots", on (pod 2, data 2) under ``hier`` and ``hier1``, each
    with its state after ten steps; ten ZeRO-3 ``hier`` steps of the
    reduced hybrid, with its state after the first."""
    from repro_torch.checkpoint import DiskCheckpointer
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_custom_mesh
    from repro_torch.models import registry
    from repro_torch.optim import AdamW

    def restore(name, cfg):
        like = {"p": registry.init(0, cfg, "cpu")}
        return DiskCheckpointer(workdir).restore(name, like)[0]["p"]

    cfg = reduced(ARCHS["olmo-1b"])
    ref_params = restore("ref_init", cfg)
    out = {}
    for strat in ("hier", "hier1", "allreduce"):
        _, losses, _ = train_mod.train(
            cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            strategy=strat, params=ref_params, device="cpu",
            log_every=TRAIN_STEPS)
        out[f"curve/{strat}"] = np.array(losses)

    data4 = make_custom_mesh("4x1", "cpu")
    _run_steps(cfg, data4, "hier", ref_params, TRAIN_SHORT, out, "data4/hier")
    update = AdamW.update
    AdamW.update = lambda self, g, s, p, sharded=None: update(self, g, s, p)
    try:
        _run_steps(cfg, data4, "hier", ref_params, TRAIN_SHORT, out,
                   "data4/hier_shard_norm")
    finally:
        AdamW.update = update
    pod = make_custom_mesh("2x2x1", "cpu")
    for strat in ("hier", "hier1"):
        _run_steps(cfg, pod, strat, ref_params, TRAIN_SHORT, out,
                   f"pod/{strat}")
    runs = [(cfg, data4, strat, f"fsdp/{strat}")
            for strat in ("hier", "hier1", "allreduce")]
    runs += [(cfg.replace(remat=True, remat_policy=policy), data4, "hier",
              f"fsdp_remat/{policy}") for policy in ("full", "dots")]
    runs += [(cfg, pod, strat, f"fsdp_pod/{strat}")
             for strat in ("hier", "hier1")]
    for run_cfg, mesh, strat, key in runs:
        _run_steps(run_cfg, mesh, strat, ref_params, TRAIN_STEPS, out, key,
                   fsdp=True, snap=TRAIN_SHORT)
    hybrid = reduced(ARCHS[HYBRID_ARCH])
    _run_steps(hybrid, data4, "hier", restore("ref_init_hybrid", hybrid),
               TRAIN_SHORT, out, "fsdp_hybrid/hier", fsdp=True, snap=1)
    _save(workdir, "train", rank, out)


# tensor parallelism: the cases held on each mesh, name -> (arch, the
# config override both packages take). "phi4-mini-3.8b/h6" has 6 heads, so
# that on 4 ranks the specs split wq inside a head (1.5 heads a rank, as
# phi4-mini's 24 heads on 16); "qwen2-moe-a2.7b/e6" has 6 experts, which do
# not divide 4 ranks (the per-expert fallback); "qwen2-moe-a2.7b/g32"
# dispatches in groups of 32 tokens, one sequence, so that a data rank's
# rows make the same groups as the global batch (with the default group of
# 4096 every rank would route its rows as one group, and the reference the
# whole batch as one). Reduced qwen2.5-3b and phi4-mini have one 32-wide
# KV head: wk / wv split inside it. "qwen2.5-3b/nope" attends without
# the rotary embedding, an option the reference does not have: it runs on
# qwen2.5-3b's init, in the prefill and serve steps against world size 1
# only (its one-KV-head cache splits the head dim, so its decode takes the
# split-dims contraction).
TP_CASES = {
    "olmo-1b": ("olmo-1b", {}),
    "qwen2.5-3b": ("qwen2.5-3b", {}),
    "phi4-mini-3.8b": ("phi4-mini-3.8b", {}),
    "phi4-mini-3.8b/h6": ("phi4-mini-3.8b", {"n_heads": 6}),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
    "qwen2-moe-a2.7b/e6": ("qwen2-moe-a2.7b", {"n_experts": 6}),
    "qwen2-moe-a2.7b/g32": ("qwen2-moe-a2.7b", {"moe_group": 32}),
    "mamba2-2.7b": ("mamba2-2.7b", {}),
    "qwen2.5-3b/nope": ("qwen2.5-3b", {"nope": True}),
}
TP_MESHES = {
    "1x2": ["olmo-1b", "qwen2.5-3b", "phi4-mini-3.8b", "qwen2-moe-a2.7b",
            "mamba2-2.7b"],
    "1x4": ["olmo-1b", "qwen2.5-3b", "phi4-mini-3.8b", "phi4-mini-3.8b/h6",
            "qwen2-moe-a2.7b", "qwen2-moe-a2.7b/e6", "mamba2-2.7b"],
    "2x2": ["olmo-1b", "qwen2.5-3b", "phi4-mini-3.8b",
            "qwen2-moe-a2.7b/g32", "mamba2-2.7b"],
}
# the hybrid, vlm and audio families (test_torch_tp_families*.py, suites
# tpf2 and tpf4): "zamba2-7b/kv2" has 2 KV heads, which do not divide 4
# ranks, so its ring splits their dims; reduced llama-vision has one KV
# head, so its cross K/V splits the head dim on every mesh (and
# tests/torch_tp_ref.py opens its gates to 0.5 on both sides). The "/seq"
# cases run seq_shard (the reference's one-device program is the one
# without it: the constraint changes no number); olmo-1b has no norm
# parameters, so qwen2.5-3b is the dense family's case on "1x2"
TP_CASES.update({
    "zamba2-7b": ("zamba2-7b", {}),
    "zamba2-7b/kv2": ("zamba2-7b", {"n_kv_heads": 2}),
    "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {}),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}),
    **{f"{arch}/seq": (arch, {"seq_shard": True}) for arch in (
        "olmo-1b", "qwen2.5-3b", "qwen2-moe-a2.7b", "mamba2-2.7b",
        "zamba2-7b", "llama-3.2-vision-90b", "seamless-m4t-medium")},
})
TP_FAMILIES = ["zamba2-7b", "llama-3.2-vision-90b", "seamless-m4t-medium"]
TP_FAMILY_MESHES = {
    "1x2": TP_FAMILIES + [f"{a}/seq" for a in (
        "qwen2.5-3b", "qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b",
        "llama-3.2-vision-90b", "seamless-m4t-medium")],
    "1x4": TP_FAMILIES + ["zamba2-7b/kv2", "olmo-1b/seq"],
    "2x2": TP_FAMILIES,
}
# their prefill and serve steps: a prompt of TP_RING_PROMPT, longer than
# reduced zamba2's window of 32, so that its ring wraps, then TP_DECODE
# teacher-forced tokens, into a cache of TP_RING_SEQ
TP_RING_PROMPT, TP_RING_SEQ = 40, 48
TP_FAMILY_STEP_MESHES = {"1x2": TP_FAMILIES, "1x4": ["zamba2-7b/kv2"]}
TP_BATCH, TP_SEQ = 4, 32          # configs.reduced_batch
# the steps on "1x2": prefill TP_PREFILL tokens into a TP_SEQ cache, then
# teacher-forced decode of the next TP_DECODE
TP_PREFILL, TP_DECODE = 24, 3
TP_STEP_CASES = ["olmo-1b", "qwen2.5-3b", "qwen2-moe-a2.7b", "mamba2-2.7b",
                 "qwen2.5-3b/nope"]
# the dry run's FLOPs at world 2 against a real rank's
TP_DRYRUN_ARCHS = ["olmo-1b", "qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b",
                   "llama-3.2-vision-90b", "seamless-m4t-medium"]
TP_DRYRUN_BATCH = 2


def tp_config(case):
    """The port's reduced config of a TP_CASES entry."""
    from repro_torch.configs import ARCHS, reduced
    arch, over = TP_CASES[case]
    return reduced(ARCHS[arch]).replace(**over)


def masked_batch(vocab: int):
    """ROADMAP C1's batch: tokens RandomState(0).randint(0, vocab, (4, 16)),
    labels the tokens with rows 0-1 masked (-1) from position 2 on."""
    toks = np.random.RandomState(0).randint(0, vocab, (4, 16)).astype(
        np.int32)
    labels = toks.copy()
    labels[:2, 2:] = -1
    return {"tokens": toks, "labels": labels}


def save_tree(path, tree):
    """A tree of numpy arrays (or tensors) -> an npz keyed by leaf path."""
    from repro_torch.core import tree as T
    np.savez(path, **{p: np.asarray(x) for p, x in T.leaves_with_path(tree)})


def load_params(path, cfg):
    """``save_tree``'s file -> the port's params of ``cfg`` on the CPU."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.models import registry
    like = registry.init(0, cfg, device="meta")
    with np.load(path) as f:
        return T.unflatten(like, [torch.from_numpy(f[p].copy())
                                  for p, _ in T.leaves_with_path(like)])


def _tp_forward(cfg, mesh, params, batch_np, out, key):
    """Logits (this data rank's rows, every vocab column), the global
    batch's loss and its gradient (whole leaves) of ``cfg`` on ``mesh``,
    each rank on its model parts: into ``out`` under ``key``."""
    from repro_torch.core import tree as T
    from repro_torch.core.hier_sync import all_reduce
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    step = make_train_step(cfg, mesh)
    held = step.shard_params(params)
    batch = T.from_numpy(step.local_batch(batch_np), "cpu")
    loss, grads = step.loss_and_grads(held, batch)
    grads = T.tree_map(lambda g: all_reduce(g, step.group) / step.n_data,
                       grads)
    pre = make_prefill_step(cfg, mesh)
    logits, _ = pre(held, batch)
    with tp.model_parallel(pre.model_group):
        logits = tp.gather_from_model(logits, -1) \
            if logits.shape[-1] != cfg.vocab_padded else logits
    out[f"{key}/loss"] = (all_reduce(loss, step.group) / step.n_data).numpy()
    out[f"{key}/logits"] = logits.numpy()
    out[f"{key}/rows"] = np.array([step.index * batch["tokens"].shape[0],
                                   batch["tokens"].shape[0]])
    for path, g in T.leaves_with_path(step.gather_params(grads)):
        out[f"{key}/grads/{path}"] = g.numpy()
    out[f"{key}/n_split"] = np.array(sum(d is not None for d in step.model))


def _tp_models(mesh_name, mesh, workdir, out, cases=None):
    from repro_torch.configs import reduced_batch
    for case in TP_MESHES[mesh_name] if cases is None else cases:
        cfg = tp_config(case)
        params = load_params(os.path.join(
            workdir, f"init_{case.replace('/', '_')}.npz"), cfg)
        _tp_forward(cfg, mesh, params,
                    reduced_batch(cfg, TP_BATCH, TP_SEQ), out,
                    f"{mesh_name}/{case}")


def _tp_steps(mesh, workdir, out, cases=None, prompt=TP_PREFILL,
              max_seq=TP_SEQ, prefix="steps"):
    """make_prefill_step / make_serve_step on ``mesh`` against the same
    calls at world size 1 (registry.prefill / decode_step on the whole
    params, in this process): the last position's logits of prefill (of
    ``prompt`` tokens into a ``max_seq`` cache) and of each decode step,
    and the caches gathered back."""
    import torch
    from repro_torch.configs import reduced_batch
    from repro_torch.core import tree as T
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import registry
    for case in TP_STEP_CASES if cases is None else cases:
        cfg = tp_config(case)
        params = load_params(os.path.join(
            workdir, f"init_{case.replace('/', '_')}.npz"), cfg)
        pre, serve = make_prefill_step(cfg, mesh), make_serve_step(cfg, mesh)
        held = pre.shard_params(params)
        batch = T.from_numpy(reduced_batch(cfg, TP_BATCH, max_seq), "cpu")
        toks = batch.pop("tokens")
        batch.pop("labels")
        prompts = dict(batch, tokens=toks[:, :prompt])
        key = f"{prefix}/{case}"

        def whole(logits, step):
            with tp.model_parallel(step.model_group):
                return (tp.gather_from_model(logits, -1)
                        if logits.shape[-1] != cfg.vocab_padded else logits)
        got, cache = pre(held, prompts, max_seq=max_seq)
        want, wcache = registry.prefill(params, cfg, prompts,
                                        max_seq=max_seq)
        logits = [(whole(got, pre)[:, -1], want[:, -1])]
        out[f"{key}/cache_shapes"] = np.array(
            repr([tuple(x.shape) for x in T.leaves(cache)]))
        for pos in range(prompt, prompt + TP_DECODE):
            got, cache = serve(held, cache, pos, toks[:, pos:pos + 1])
            want, wcache = registry.decode_step(params, cfg, wcache, pos,
                                                toks[:, pos:pos + 1])
            logits.append((whole(got, serve)[:, -1], want[:, -1]))
        out[f"{key}/got"] = torch.stack([a for a, _ in logits]).numpy()
        out[f"{key}/want"] = torch.stack([b for _, b in logits]).numpy()
        for (path, a), b in zip(T.leaves_with_path(serve.gather_cache(cache)),
                                T.leaves(wcache)):
            out[f"{key}/cache/{path}"] = a.numpy()
            out[f"{key}/want_cache/{path}"] = b.numpy()


def _c1(workdir, out):
    """ROADMAP C1: one step of each strategy, ZeRO-3 off and on, on the
    masked batch over (data 2): the loss and the whole first moments."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core import tree as T
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_custom_mesh
    from repro_torch.optim import AdamW
    cfg = reduced(ARCHS["olmo-1b"])
    params = load_params(os.path.join(workdir, "init_olmo-1b.npz"), cfg)
    mesh = make_custom_mesh("2x1", "cpu")
    steps_mod.FSDP_MIN_SIZE = FSDP_MIN_SIZE
    for strat in ("hier", "hier1", "allreduce"):
        for fsdp in (False, True):
            step = steps_mod.make_train_step(cfg, mesh, strategy=strat,
                                             fsdp=fsdp,
                                             optimizer=AdamW(lr=3e-4))
            held = step.shard_params(params)
            b = T.from_numpy(step.local_batch(masked_batch(cfg.vocab_size)),
                             "cpu")
            _, state, loss = step(held, step.init_opt_state(held), b)
            key = f"c1/{strat}/{'fsdp' if fsdp else 'replicated'}"
            out[f"{key}/loss"] = loss.numpy()
            for path, x in T.leaves_with_path(step.gather_opt_state(state).mu):
                out[f"{key}/mu/{path}"] = x.numpy()


def _tp_dryrun_flops(out):
    """Rank 0's FLOPs of the dry run's train step of each
    TP_DRYRUN_ARCHS on a real "1x2" mesh (FlopCounterMode; seed-0
    weights, a zero batch), as tests/test_torch_dryrun.py's world-1
    check."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_custom_mesh
    from repro_torch.models import registry
    from repro_torch.models.base import InputShape
    steps_mod.FSDP_MIN_SIZE = FSDP_MIN_SIZE
    shape = InputShape("train_small", TP_SEQ, TP_DRYRUN_BATCH, "train")
    mesh = make_custom_mesh("1x2", "cpu")
    for arch in TP_DRYRUN_ARCHS:
        cfg = D.dryrun_config(arch, shape, cfg=reduced(ARCHS[arch]))
        step = D.make_step(cfg, shape, mesh)
        args = D.step_args(step, cfg, shape, device="cpu",
                           init=lambda p: registry.init(0, cfg, "cpu"))
        with FlopCounterMode(display=False) as flops:
            step(*args)
        out[f"dryrun/{arch}/flops"] = np.array(flops.get_total_flops())


def suite_tp2(rank, world, workdir):
    """2 ranks: the TP cases on (model 2), the prefill and serve steps on
    (model 2), ROADMAP C1 on (data 2), and the dry run's world-2 FLOPs."""
    from repro_torch.launch.mesh import make_custom_mesh
    out = {}
    _tp_models("1x2", make_custom_mesh("1x2", "cpu"), workdir, out)
    _tp_steps(make_custom_mesh("1x2", "cpu"), workdir, out)
    _c1(workdir, out)
    _tp_dryrun_flops(out)
    _save(workdir, "tp2", rank, out)


def suite_tpf2(rank, world, workdir):
    """2 ranks: the hybrid, vlm and audio cases and one seq_shard case of
    each family on (model 2), and the three families' prefill and serve
    steps on (model 2), zamba2's ring wrapped."""
    from repro_torch.launch.mesh import make_custom_mesh
    out = {}
    mesh = make_custom_mesh("1x2", "cpu")
    _tp_models("1x2", mesh, workdir, out, TP_FAMILY_MESHES["1x2"])
    _tp_steps(mesh, workdir, out, TP_FAMILY_STEP_MESHES["1x2"],
              TP_RING_PROMPT, TP_RING_SEQ, "steps1x2")
    _save(workdir, "tpf2", rank, out)


def suite_tpf4(rank, world, workdir):
    """4 ranks: the hybrid, vlm and audio cases on (model 4) and (data 2,
    model 2), zamba2 with a head-dim-split ring (its steps too) and
    olmo-1b under seq_shard on (model 4)."""
    from repro_torch.launch.mesh import make_custom_mesh
    out = {}
    mesh = make_custom_mesh("1x4", "cpu")
    _tp_models("1x4", mesh, workdir, out, TP_FAMILY_MESHES["1x4"])
    _tp_steps(mesh, workdir, out, TP_FAMILY_STEP_MESHES["1x4"],
              TP_RING_PROMPT, TP_RING_SEQ, "steps1x4")
    _tp_models("2x2", make_custom_mesh("2x2", "cpu"), workdir, out,
               TP_FAMILY_MESHES["2x2"])
    _save(workdir, "tpf4", rank, out)


def suite_tp4(rank, world, workdir):
    """4 ranks: the TP cases on (model 4) and on (data 2, model 2), and
    the reference's 40-step ``hier`` curve on (data 2, model 2), with
    ZeRO-3 off and on, and on under remat, with the state after the first
    step."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch.mesh import make_custom_mesh
    out = {}
    _tp_models("1x4", make_custom_mesh("1x4", "cpu"), workdir, out)
    mesh = make_custom_mesh("2x2", "cpu")
    _tp_models("2x2", mesh, workdir, out)
    cfg = reduced(ARCHS["olmo-1b"])
    params = load_params(os.path.join(workdir, "init_olmo-1b.npz"), cfg)
    for key, run_cfg, fsdp in (
            ("replicated", cfg, False), ("fsdp", cfg, True),
            ("fsdp_remat", cfg.replace(remat=True), True)):
        _run_steps(run_cfg, mesh, "hier", params, TRAIN_STEPS, out,
                   f"curve2x2/{key}", fsdp=fsdp, snap=1)
    _save(workdir, "tp4", rank, out)


def main():
    suite, rank, world, workdir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, suite + '.init')}",
        world_size=world, rank=rank)
    try:
        {"hier_sync": suite_hier_sync, "train": suite_train,
         "tp2": suite_tp2, "tp4": suite_tp4, "tpf2": suite_tpf2,
         "tpf4": suite_tpf4}[suite](rank, world, workdir)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"OK {suite} rank {rank}")


if __name__ == "__main__":
    main()
