"""Architecture registry of the port.

Mirrors ``repro.configs``: ``--arch <id>`` names map to configs, one module
each, copied from the reference's: the reference's ten architectures.
"""

from __future__ import annotations

import importlib

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


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
