"""Feed-forward blocks. Port of ``repro.models.moe``: the dense SwiGLU FFN
only; the routed MoE FFN is not ported yet (ROADMAP.md queue 1)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ArchConfig, ParamBuilder


def init_dense_ffn(pb: ParamBuilder, cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": pb.dense((d, f)),
        "w_up": pb.dense((d, f)),
        "w_down": pb.dense((f, d)),
    }


def dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (F.silu(g) * u) @ p["w_down"]
