"""End-to-end example on the PyTorch port: train a ~100M-param dense LM with
the full stack — Workspace data circuit, the train step, provenance,
checkpoints, fault-tolerant resume — through ``repro_torch.launch.train``.

The run of ``examples/train_lm.py`` on ``repro_torch``: the stablelm family
at d_model=512, 8 layers, vocab 100352, f32, remat "none" (vocab embedding
dominates: ~51M embed + ~51M head + 25M body ≈ 128M); on the card its
attention runs flash_attention and its backward on their f32 routes at
head dim 64. Checkpoints go under a temporary directory unless
``--ckpt-dir`` names one.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300             # on the card
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 2 --batch 2 --seq 32
(defaults to 30 steps so a run stays short; pass --steps 300 for the real run)
"""

import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch import train as train_driver
from repro_torch.models.common import resolve_device


def config_100m():
    """The ~100M config, registered under the stablelm family."""
    return dataclasses.replace(
        get_config("stablelm-1.6b"),
        name="stablelm-100m",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_head=64,
        d_ff=1408,
        dtype="float32",
        remat="none",
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint directory (default: a new temporary one)")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # raises before anything is made where CUDA is asked for and absent

    cfg100m = config_100m()
    print(f"training {cfg100m.name}: {cfg100m.n_params()/1e6:.0f}M params")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_100m_")
    print(f"checkpoints under {ckpt_dir}")
    # register the config where the driver looks it up, for this run only
    orig_get = train_driver.get_config
    train_driver.get_config = lambda a: cfg100m if a == "stablelm-100m" else orig_get(a)
    try:
        return train_driver.main(
            [
                "--arch", "stablelm-100m",
                "--steps", str(args.steps),
                "--batch", str(args.batch),
                "--seq", str(args.seq),
                "--ckpt-every", str(max(10, args.steps // 3)),
                "--ckpt-dir", ckpt_dir,
                "--device", args.device,
            ]
        )
    finally:
        train_driver.get_config = orig_get


if __name__ == "__main__":
    main()
