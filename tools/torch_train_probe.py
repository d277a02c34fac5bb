#!/usr/bin/env python3
"""Train one architecture of the PyTorch port at full width on one card for a
few steps of ``make_train_step`` on one repeated batch, and print each step's
loss, grad norm and time and the peak device memory:

  python3 tools/torch_train_probe.py --arch minicpm3-4b [--lr 3e-5 ...] [--plain]

Each ``--lr`` trains all the config's layers from the same random weights
(seed 0) for ``STEPS`` steps on the data circuit's first batch of ``BATCH`` x
``SEQ`` tokens, as ``chip_smoke.py`` phase 5h takes it, with the stub frames
or prefix that ``launch.train.run`` draws at step 0. ``--plain`` also runs
every lr with the attention kernels swapped for their plain versions
(``kernels/ref.py``), so that a loss curve can be told apart from a kernel's
arithmetic.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, STEPS = 4, 1024, 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-5])
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import build_data_pipeline, next_batch
    from repro_torch.dist.step import make_train_step
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import _stub_embeddings
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init, constant_lr

    if not torch.cuda.is_available():
        print("torch_train_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    B, L = BATCH, SEQ
    data = build_data_pipeline(cfg, B, L, seed=0)
    batch = {k: torch.from_numpy(np.asarray(v, dtype=np.int32)).to(dev) for k, v in next_batch(data, cfg).items()}
    if cfg.encoder_layers:
        batch["frames"] = _stub_embeddings(cfg, B, 0, dev)
    if cfg.frontend == "vision":
        batch["prefix"] = _stub_embeddings(cfg, B, 0, dev)
    model = build_model(cfg)
    plain = {"flash_attention": ref.reference_attention, "flash_attention_bwd": ref.reference_attention_bwd}
    for lr in args.lr:
        for versions in ("kernels", "plain") if args.plain else ("kernels",):
            kept = dict(ops.KERNELS)
            if versions == "plain":
                ops.KERNELS.update(plain)
            try:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                params = model.init(0, dev)
                state = {"params": params, "opt": adamw_init(params),
                         "step": torch.zeros((), dtype=torch.int32, device=dev)}
                step = make_train_step(model, dev, constant_lr(lr), global_batch=B)
                for i in range(STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, met = step(state, batch)
                    torch.cuda.synchronize()
                    print(f"{cfg.name} ({cfg.n_layers} layers, batch {B} x {L}) {versions} lr {lr:g} "
                          f"step {i}: loss {met['loss'].item():.5f} grad_norm {met['grad_norm'].item():.4f} "
                          f"({time.perf_counter() - t0:.3f} s)", flush=True)
                print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
                del state, params, step
            finally:
                ops.KERNELS.clear()
                ops.KERNELS.update(kept)
    return 0


if __name__ == "__main__":
    sys.exit(main())
