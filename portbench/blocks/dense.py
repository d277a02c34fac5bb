"""The dense SwiGLU FFN: the port's ``models/moe.py::init_dense_ffn`` and
``dense_ffn``, down(silu(gate(h)) * up(h))."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import Precision

SLOT = "ffn"


def runs(spec, cfg) -> bool:
    return spec.ffn == "dense"


KEYS = {"intermediate_size": "d_ff"}


def plan(cfg: dict) -> dict:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return {
        "w_gate": ("randn", (d, f), d ** -0.5),
        "w_up": ("randn", (d, f), d ** -0.5),
        "w_down": ("randn", (f, d), f ** -0.5),
    }


def dense_ffn(p: dict, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(h, p["w_gate"])) * prec.mm(h, p["w_up"]), p["w_down"])


def forward(p: dict, cfg: dict, h: torch.Tensor, prec: Precision, prompt_len: int) -> tuple:
    return dense_ffn(p, h, prec), 0


def products(cfg: dict, active: bool) -> int:
    return 3 * cfg["hidden_size"] * cfg["intermediate_size"]
