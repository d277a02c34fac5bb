"""End-to-end training run, PyTorch port of ``repro.launch.train``.

The training loop is Koalja circuitry end to end: batches arrive as
AnnotatedValues from the data circuit (``repro_torch.data.pipeline``), each
optimizer step is logged in the provenance registry, and checkpoints are AVs
whose travel documents name the code version and step that produced them.
Fault tolerance is make-mode: on a (simulated) failure ``main`` restores
the latest checkpoint and replays. As in the reference, the data circuit is
built once and not rewound on restore: the steps after a resume take the
next batches, not the ones they replace.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --batch 8 --seq 2048 --steps 20 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 6 --batch 4 --seq 32 --ckpt-every 2 --fail-at-step 3

Weights are random, drawn from ``--seed``. The step runs on ``--device``
(default ``cuda``, which raises without a card).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import ProvenanceRegistry, software_version_of
from repro_torch.data.pipeline import build_data_pipeline, next_batch
from repro_torch.dist.ft import FaultToleranceManager, SimulatedFailure
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.registry import build_model, train_loss
from repro_torch.optim import adamw_init, cosine_warmup
from repro_torch.workspace import MeshExecutor


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a simulated host failure (tests recovery)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="compute dtype (default: the config's own; --reduced makes it float32)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = build_model(cfg)
    schedule = cosine_warmup(args.lr, max(2, args.steps // 10), args.steps)

    # the executor backend owns the device; the same call targets another
    # device by swapping the executor, nothing else
    executor = MeshExecutor(make_host_mesh(device=args.device), cfg=cfg, mode="train", global_batch=args.batch)
    dev = executor.mesh
    train_step = executor.train_step(model, schedule, microbatches=args.microbatches)

    registry = ProvenanceRegistry()
    sw = software_version_of(train_loss)
    registry.register_task("train_step", ["batch"], ["state", "metrics"], sw)
    ckpt = CheckpointManager(args.ckpt_dir, software_version=sw)
    data = build_data_pipeline(cfg, args.batch, args.seq, seed=args.seed)
    ft = FaultToleranceManager(n_hosts=1)

    def fresh_state():
        params = model.init(args.seed, dev)
        return {
            "params": params,
            "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def restore():
        last = ckpt.latest_step()
        if args.resume and last is not None:
            state, manifest = ckpt.restore(fresh_state())
            print(f"[restore] step {last} (sw={manifest['software_version']})")
            return state, last
        return fresh_state(), 0

    def run(start_state, start_step):
        state = start_state
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = next_batch(data, cfg)
            batch = {k: torch.from_numpy(np.asarray(v, dtype=np.int32)).to(dev) for k, v in batch.items()}
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            ft.heartbeat(0, dt)
            registry.log_visit("train_step", f"step-{step}", "executed", sw,
                               note=f"loss={loss:.4f} wall={dt:.3f}s")
            if step == args.fail_at_step:
                ckpt.wait()
                raise SimulatedFailure(host=0, msg=f"injected at step {step}")
            print(
                f"step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.3f} "
                f"({dt:.2f}s)"
            )
            if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                ckpt.save_async(state, step + 1, meta={"loss": loss})
        ckpt.wait()
        return state

    # make-mode recovery loop
    attempts = 0
    while True:
        state, start = restore()
        try:
            state = run(state, start)
            break
        except SimulatedFailure as e:
            attempts += 1
            args.resume = True
            args.fail_at_step = -1  # replacement host joins; don't re-fail
            print(f"[ft] {e} -> restart from latest checkpoint (attempt {attempts})")
            if attempts > 3:
                raise

    print(f"[done] {args.steps} steps; checkpoints: {[a.meta['step'] for a in ckpt.saved]}")
    print(f"[provenance] visitor log entries: {len(registry.visitor_log('train_step'))}")
    return state


if __name__ == "__main__":
    main()
