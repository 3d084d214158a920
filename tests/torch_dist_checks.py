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


# the reference's 40-step run: tests/test_torch_train.py
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 40, 8, 128


def _run_steps(cfg, mesh, strategy, params, n_steps, out, key):
    """``n_steps`` of make_train_step(strategy) on ``mesh`` with
    launch/train.py's 40-step optimizer and data; into ``out`` under
    ``key``: the losses, this rank's moments, the gathered moments and
    the params."""
    from repro_torch.core import tree as T
    from repro_torch.data import DataConfig, ShardedLoader, TokenDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, warmup_cosine
    opt = AdamW(lr=3e-4, schedule=warmup_cosine(2, TRAIN_STEPS))
    step = make_train_step(cfg, mesh, strategy=strategy, optimizer=opt)
    state = step.init_opt_state(params)
    loader = ShardedLoader(TokenDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ)))
    losses = []
    for _ in range(n_steps):
        b = T.from_numpy(step.local_batch(loader.next_batch(TRAIN_BATCH)),
                         "cpu")
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
    full = step.gather_opt_state(state)
    out[f"{key}/curve"] = np.array(losses)
    for name, tree in (("mu", state.mu), ("full_mu", full.mu),
                       ("full_nu", full.nu), ("params", params)):
        for path, x in T.leaves_with_path(tree):
            out[f"{key}/{name}/{path}"] = x.numpy()


def suite_train(rank, world, workdir):
    """launch/train.py::train on 4 ranks from the reference's weights, per
    strategy; ten ``hier`` steps on (data 4), once more with a clip by
    each rank's own shard norm (what the group sum prevents); ten
    ``hier`` and ``hier1`` steps on (pod 2, data 2)."""
    from repro_torch.checkpoint import DiskCheckpointer
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_custom_mesh
    from repro_torch.models import registry
    from repro_torch.optim import AdamW

    cfg = reduced(ARCHS["olmo-1b"])
    like = {"p": registry.init(0, cfg, "cpu")}
    ref_params = DiskCheckpointer(workdir).restore("ref_init", like)[0]["p"]
    out = {}
    for strat in ("hier", "hier1", "allreduce"):
        _, losses, _ = train_mod.train(
            cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            strategy=strat, params=ref_params, device="cpu",
            log_every=TRAIN_STEPS)
        out[f"curve/{strat}"] = np.array(losses)

    data4 = make_custom_mesh("4x1", "cpu")
    _run_steps(cfg, data4, "hier", ref_params, 10, out, "data4/hier")
    update = AdamW.update
    AdamW.update = lambda self, g, s, p, group=None, sharded=None: \
        update(self, g, s, p)
    try:
        _run_steps(cfg, data4, "hier", ref_params, 10, out,
                   "data4/hier_shard_norm")
    finally:
        AdamW.update = update
    pod = make_custom_mesh("2x2x1", "cpu")
    for strat in ("hier", "hier1"):
        _run_steps(cfg, pod, strat, ref_params, 10, out, f"pod/{strat}")
    _save(workdir, "train", rank, out)


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
        {"hier_sync": suite_hier_sync, "train": suite_train}[suite](
            rank, world, workdir)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"OK {suite} rank {rank}")


if __name__ == "__main__":
    main()
