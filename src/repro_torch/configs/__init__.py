"""Architecture registry of the port.

Mirrors ``repro.configs``: ``--arch <id>`` names map to configs. The ids are
the reference's ten; the dense full-attention family, the MoE (phi3.5-moe),
the hybrid (jamba) and the SSM (falcon-mamba) are ported so far, and asking
for any other architecture raises ``NotImplementedError`` naming the
``ROADMAP.md`` item that ports it.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ArchConfig

_MODULES = {
    "internlm2-20b": "internlm2_20b",
    "qwen2.5-32b": "qwen2_5_32b",
    "stablelm-1.6b": "stablelm_1_6b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "phi3.5-moe-42b": "phi3_5_moe_42b",
}

# architecture -> the ROADMAP.md queue-1 item that will port it
_NOT_PORTED = {
    "mixtral-8x7b": "item 3 (MoE: the SWA ring cache)",
    "minicpm3-4b": "item 5 (remaining architectures: MLA)",
    "internvl2-1b": "item 5 (remaining architectures: vision prefix)",
    "seamless-m4t-medium": "item 5 (remaining architectures: encoder-decoder)",
}

ARCH_IDS = tuple(_MODULES) + tuple(_NOT_PORTED)


def get_config(arch: str) -> ArchConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to repro_torch yet: ROADMAP.md queue 1, {_NOT_PORTED[arch]}"
        )
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
