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
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \\
      --reduced --device cpu

``run(cfg, ...)`` is the same loop for an ``ArchConfig`` built in code (a
depth-cut config, as ``chip_smoke.py`` trains), as ``launch.serve.run`` is
for serving. As in the reference, an encoder-decoder's stub ``frames`` and
a vision model's stub ``prefix`` (``cfg.frontend_len`` embeddings of
``d_model``) are drawn each step as f32 ``RandomState(step).randn``, since
the data circuit carries tokens only.

Weights are random, drawn from ``--seed``. The step runs on ``--device``
(default ``cuda``, which raises without a card). Under ``torchrun`` (or any
launcher that sets ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR``), each rank
joins the process group (NCCL on cards, each rank on ``LOCAL_RANK``'s; gloo
on the CPU) and trains the sharded step on ``make_host_mesh(--model)``,
(world / model, model): every rank draws the same global batch from the data
circuit and takes its rows, and writes its own shards to
``<ckpt-dir>/rank_<r>``.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch stablelm-1.6b \\
      --batch 8 --seq 2048 --steps 20 --model 2
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
from repro_torch.dist.step import is_mesh, mesh_device, placed_train_state
from repro_torch.launch.mesh import join_process_group, make_host_mesh
from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import build_model, train_loss
from repro_torch.optim import adamw_init, cosine_warmup
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.workspace import MeshExecutor

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def _stub_embeddings(cfg: ArchConfig, batch: int, step: int, dev) -> torch.Tensor:
    """(batch, frontend_len, d_model) f32 stub frontend embeddings of a step,
    the reference's ``np.random.RandomState(step).randn``."""
    x = np.random.RandomState(step).randn(batch, cfg.frontend_len, cfg.d_model).astype(np.float32)
    return torch.from_numpy(x).to(dev)


def run(
    cfg: ArchConfig,
    *,
    steps: int = 20,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    microbatches: int = 1,
    ckpt_every: int = 10,
    ckpt_dir: str = DEFAULT_CKPT_DIR,
    resume: bool = False,
    fail_at_step: int = -1,
    seed: int = 0,
    device="cuda",
    model_axis: int = 1,
):
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens from the
    data circuit, with random weights from ``seed``, on ``device``: AdamW
    under a cosine warmup to ``lr``, a checkpoint every ``ckpt_every`` steps
    and after the last, and make-mode recovery from ``fail_at_step``.
    In a process group, on the mesh (world / ``model_axis``, ``model_axis``)
    (module docstring). Prints each step's loss (rank 0); returns the final
    train state (placed, on a mesh)."""
    model = build_model(cfg)
    schedule = cosine_warmup(lr, max(2, steps // 10), steps)

    # the executor backend owns the device or mesh; the same call targets
    # another by swapping the executor, nothing else
    mesh = make_host_mesh(model=model_axis, device=device)
    executor = MeshExecutor(mesh, cfg=cfg, mode="train", global_batch=batch)
    sharded = is_mesh(mesh)
    dev = mesh_device(mesh) if sharded else mesh
    rank = torch.distributed.get_rank() if sharded else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    train_step = executor.train_step(model, schedule, microbatches=microbatches)
    if sharded:
        train_step, _, state_shard, _ = train_step

    registry = ProvenanceRegistry()
    sw = software_version_of(train_loss)
    registry.register_task("train_step", ["batch"], ["state", "metrics"], sw)
    ckpt = CheckpointManager(os.path.join(ckpt_dir, f"rank_{rank}") if sharded else ckpt_dir, software_version=sw)
    data = build_data_pipeline(cfg, batch, seq, seed=seed)
    ft = FaultToleranceManager(n_hosts=1)

    def fresh_state():
        params = model.init(seed, dev)
        if sharded:
            return placed_train_state(params, state_shard, mesh)
        return {
            "params": params,
            "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def local(state):
        return tree_map(lambda t: t.to_local(), state) if sharded else state

    def restore():
        last = ckpt.latest_step()
        if resume and last is not None:
            state = fresh_state()
            shards, manifest = ckpt.restore(local(state))
            for dst, src in zip(tree_leaves(local(state)), tree_leaves(shards)):
                dst.copy_(src)
            say(f"[restore] step {last} (sw={manifest['software_version']})")
            return state, last
        return fresh_state(), 0

    def run_steps(start_state, start_step):
        state = start_state
        for step in range(start_step, steps):
            t0 = time.time()
            b = {k: torch.from_numpy(np.asarray(v, dtype=np.int32 if k in ("tokens", "labels") else np.float32))
                 .to(dev) for k, v in next_batch(data, cfg).items()}
            if cfg.encoder_layers and "frames" not in b:
                b["frames"] = _stub_embeddings(cfg, batch, step, dev)
            if cfg.frontend == "vision" and "prefix" not in b:
                b["prefix"] = _stub_embeddings(cfg, batch, step, dev)
            state, metrics = train_step(state, b)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            ft.heartbeat(0, dt)
            registry.log_visit("train_step", f"step-{step}", "executed", sw,
                               note=f"loss={loss:.4f} wall={dt:.3f}s")
            if step == fail_at_step:
                ckpt.wait()
                raise SimulatedFailure(host=0, msg=f"injected at step {step}")
            say(
                f"step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.3f} "
                f"({dt:.2f}s)"
            )
            if (step + 1) % ckpt_every == 0 or step + 1 == steps:
                ckpt.save_async(local(state), step + 1, meta={"loss": loss})
        ckpt.wait()
        return state

    # make-mode recovery loop
    attempts = 0
    while True:
        state, start = restore()
        try:
            state = run_steps(state, start)
            break
        except SimulatedFailure as e:
            attempts += 1
            resume = True
            fail_at_step = -1  # replacement host joins; don't re-fail
            say(f"[ft] {e} -> restart from latest checkpoint (attempt {attempts})")
            if attempts > 3:
                raise

    say(f"[done] {steps} steps; checkpoints: {[a.meta['step'] for a in ckpt.saved]}")
    say(f"[provenance] visitor log entries: {len(registry.visitor_log('train_step'))}")
    return state


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
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a simulated host failure (tests recovery)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks on the mesh's model axis (tensor and expert parallelism) in a process group")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="compute dtype (default: the config's own; --reduced makes it float32)")
    args = ap.parse_args(argv)

    join_process_group(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, microbatches=args.microbatches,
               ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, resume=args.resume,
               fail_at_step=args.fail_at_step, seed=args.seed, device=args.device, model_axis=args.model)


if __name__ == "__main__":
    main()
