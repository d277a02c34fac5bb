"""Mamba-1: the port's ``models/mamba.py::init_mamba`` and ``mamba_block``.
A depthwise causal conv with a bias, softplus dt, the selective scan from a
zero state, the D skip and the z gate; no bias on the projections and no
norms inside."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import Precision

SLOT = "mixer"


def runs(spec, cfg) -> bool:
    return spec.mixer == "mamba"


KEYS = {
    "mamba_d_state": "ssm_state", "mamba_d_conv": "ssm_conv", "mamba_expand": "ssm_expand",
    "mamba_dt_rank": lambda cfg: cfg.dt_rank,
    "mamba_conv_bias": lambda cfg: True,  # the port's conv has a bias (conv_b)
    "mamba_proj_bias": lambda cfg: False,  # its in, x, dt and out projections have none
}


def d_inner(cfg: dict) -> int:
    return cfg["mamba_expand"] * cfg["hidden_size"]


def plan(cfg: dict) -> dict:
    """Mamba's ``dt_bias`` and ``a_log`` are f32 (``weights.make_params``)."""
    d = cfg["hidden_size"]
    di, n, k, r = d_inner(cfg), cfg["mamba_d_state"], cfg["mamba_d_conv"], cfg["mamba_dt_rank"]
    return {
        "in_proj": ("randn", (d, 2 * di), d ** -0.5),
        "conv_w": ("randn", (k, di), k ** -0.5),
        "conv_b": ("zeros", (di,)),
        "x_proj": ("randn", (di, r + 2 * n), di ** -0.5),
        "dt_proj": ("randn", (r, di), r ** -0.5),
        "dt_bias": ("dt_bias", (di,)),
        "a_log": ("a_log", (di, n)),
        "d_skip": ("ones", (di,)),
        "out_proj": ("randn", (di, d), di ** -0.5),
    }


def mamba(p: dict, cfg: dict, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Mamba-1 over the whole sequence from a zero state; h (B, S, d)."""
    B, S, d = h.shape
    n, r, K = cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    xr, z = prec.mm(h, p["in_proj"]).chunk(2, dim=-1)
    w, bias = p["conv_w"].float(), p["conv_b"].float()
    xp = F.pad(xr, (0, 0, K - 1, 0))
    xc = F.silu(sum(w[k] * xp[:, k : k + S] for k in range(K)) + bias)
    proj = prec.mm(xc, p["x_proj"])
    dt = F.softplus(prec.mm(proj[..., :r], p["dt_proj"]) + p["dt_bias"].float())
    Bm, Cm = proj[..., r : r + n], proj[..., r + n :]
    a = -torch.exp(p["a_log"].float())
    state = torch.zeros((B, xc.shape[-1], n), dtype=torch.float32, device=h.device)
    y = torch.empty_like(xc)
    for t in range(S):
        state = torch.exp(dt[:, t, :, None] * a) * state + (dt[:, t] * xc[:, t])[..., None] * Bm[:, t, None, :]
        y[:, t] = torch.einsum("bin,bn->bi", state, Cm[:, t])
    y = (y + xc * p["d_skip"].float()) * F.silu(z)
    return prec.mm(y, p["out_proj"])


def forward(p: dict, cfg: dict, h: torch.Tensor, prec: Precision, prompt_len: int) -> tuple:
    return mamba(p, cfg, h, prec), 0


def products(cfg: dict, active: bool) -> int:
    d = cfg["hidden_size"]
    di, n, r, k = d_inner(cfg), cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    return 2 * d * di + k * di + di * (r + 2 * n) + r * di + di * d


def decode_extra(cfg: dict, B: int, context: int, elt: int) -> tuple:
    """The f32 state and the conv window, each read and written (the scan's
    operations are not counted)."""
    di = d_inner(cfg)
    return 0, B * di * (2 * cfg["mamba_d_state"] * 4 + 2 * (cfg["mamba_d_conv"] - 1) * elt)
