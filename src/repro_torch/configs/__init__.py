"""Architecture registry of the port.

Mirrors ``repro.configs``: ``--arch <id>`` names map to configs, one module
each, copied from the reference's: the reference's ten architectures. The
input-shape grid (``SHAPES``) and each cell's skip rule are the reference's
too: ``long_500k`` runs only for sub-quadratic architectures (SSM, hybrid,
windowed attention); a full-attention one records a skip row.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.models.common import ArchConfig

_MODULES = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b": "phi3_5_moe_42b",
    "internlm2-20b": "internlm2_20b",
    "qwen2.5-32b": "qwen2_5_32b",
    "stablelm-1.6b": "stablelm_1_6b",
    "minicpm3-4b": "minicpm3_4b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-1b": "internvl2_1b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_IDS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SHAPE_IDS = tuple(SHAPES)


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def cell_skip_reason(cfg: ArchConfig, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reason it's skipped."""
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return "full quadratic attention: long_500k requires sub-quadratic (per assignment)"
    return None


def all_cells():
    """Yield every runnable (arch_id, shape_id) cell + skip rows."""
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPE_IDS:
            yield a, s, cell_skip_reason(cfg, s)
