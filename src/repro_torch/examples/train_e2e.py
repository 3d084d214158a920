"""End-to-end SMLT training example (the port's counterpart of the JAX
package's ``examples/train_e2e.py``, with its flags).

Trains a decoder LM for a few hundred steps with:
 - the hierarchical (reduce-scatter + all-gather) gradient sync strategy
   (``launch/steps.py``'s ``hier`` step, ZeRO-style optimizer state),
 - a dynamic batch schedule (doubles at ``steps // 3``, as in the paper's
   dynamic batching workflows),
 - a checkpoint/restore cycle at ``steps // 2`` (the serverless
   duration-cap path): the state is saved, dropped and restored from disk
   with the data iterator's position, and must come back bit for bit,
 - markov-structured synthetic data so the loss visibly decreases.

Default is a 35.7M-param model (``registry.param_count``; the
reference's docstring says ~28M). The reference then projects the run onto
the serverless event engine; that needs the engine and ``Workload``, which
the port does not have yet (ROADMAP A6b, A11, A10b), so
``--skip-serverless-sim`` is the default and the projection does not run.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 300
      [--device cpu]
"""
import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointMeta, DiskCheckpointer
from repro_torch.core import tree as T
from repro_torch.data import DataConfig, IteratorState, ShardedLoader, TokenDataset
from repro_torch.launch.mesh import process_group
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import make_local_mesh
from repro_torch.models import registry
from repro_torch.models.base import ModelConfig
from repro_torch.optim import AdamW, warmup_cosine


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(b)))


def run(args):
    """Train as the module docstring says; returns the losses."""
    dev = T.resolve_device(args.device)
    cfg = ModelConfig(arch_id="e2e-lm", family="dense",
                      n_layers=args.layers, d_model=args.model_dim,
                      n_heads=max(args.model_dim // 128, 4),
                      n_kv_heads=max(args.model_dim // 256, 2),
                      d_ff=args.model_dim * 4, vocab_size=args.vocab)
    print(f"model: {registry.param_count(cfg)/1e6:.1f}M params")

    with process_group(dev), tempfile.TemporaryDirectory() as tmp:
        opt = AdamW(lr=args.lr, schedule=warmup_cosine(30, args.steps))
        step_fn = make_train_step(cfg, make_local_mesh(dev), strategy="hier",
                                  optimizer=opt)
        params = registry.init(0, cfg, dev)
        opt_state = step_fn.init_opt_state(params)

        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq)
        loader = ShardedLoader(TokenDataset(data))
        ck = DiskCheckpointer(args.ckpt_dir or tmp)

        batch_size = args.batch
        t0 = time.perf_counter()
        losses = []
        for i in range(args.steps):
            if i == args.steps // 3:
                batch_size *= 2  # dynamic batching: the batch doubles
                print(f"step {i}: batch {args.batch} -> {batch_size}")
            if i == args.steps // 2:
                # duration-cap simulation: checkpoint, drop state, restore
                saved = {"params": params,
                         "opt": step_fn.gather_opt_state(opt_state)}
                ck.save("mid", saved,
                        CheckpointMeta(step=i, epoch=loader.state.epoch,
                                       index=loader.state.index))
                restored, meta = ck.restore("mid", saved)
                if not (_equal(restored["params"], saved["params"])
                        and _equal(restored["opt"].mu, saved["opt"].mu)
                        and _equal(restored["opt"].nu, saved["opt"].nu)
                        and restored["opt"].step == saved["opt"].step):
                    raise RuntimeError("the restored state differs from the "
                                       "saved state")
                del saved
                params = restored["params"]
                opt_state = step_fn.shard_opt_state(restored["opt"])
                loader = ShardedLoader(TokenDataset(data),
                                       IteratorState(meta.epoch, meta.index))
                print(f"step {i}: checkpoint/restart cycle OK, state "
                      f"bit-equal (resumed at epoch {meta.epoch}, index "
                      f"{meta.index})")
            b = T.from_numpy(step_fn.local_batch(loader.next_batch(batch_size)),
                             dev)
            params, opt_state, loss = step_fn(params, opt_state, b)
            losses.append(float(loss))
            if i % 25 == 0 or i == args.steps - 1:
                tput = sum([args.batch] * min(i + 1, 25)) * args.seq / max(
                    time.perf_counter() - t0, 1e-9)
                print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                      f"{tput:,.0f} tok/s")
    print(f"loss: {losses[0]:.3f} -> {min(losses):.3f} "
          f"({time.perf_counter()-t0:.0f}s total)")
    assert min(losses) < losses[0] - 0.5, "training must clearly progress"
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--model-dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="where the mid-run checkpoint goes (default: a "
                    "temporary directory, removed at the end)")
    ap.add_argument("--skip-serverless-sim", action="store_true",
                    default=True,
                    help="always on: the serverless projection needs the "
                    "event engine and Workload, not ported yet (ROADMAP "
                    "A6b, A11, A10b)")
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
