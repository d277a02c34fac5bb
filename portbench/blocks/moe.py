"""The MoE SwiGLU FFN: the port's ``models/moe.py::init_moe`` and ``moe_ffn``.
Top-k routing from an f32 softmax (a stable descending sort; the k weights
renormalised) with the port's capacity rule and its drops: a token-slot is
kept iff its place in its expert's bin, in token-major order within its
dispatch group (a prefill, or one decode step), is below the group's
capacity."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import blocks
from portbench.reference.model import Precision

SLOT = "ffn"


def runs(spec, cfg) -> bool:
    return spec.ffn == "moe"


KEYS = {
    "intermediate_size": "d_ff", "num_experts": "n_experts", "num_experts_per_tok": "top_k",
    "capacity_factor": "capacity_factor", "moe_exact_tokens": "moe_exact_tokens",
    "expert_layer_period": lambda cfg: blocks.port_period(runs, cfg)[0],
    "expert_layer_offset": lambda cfg: blocks.port_period(runs, cfg)[1],
}


def plan(cfg: dict) -> dict:
    d, f, e = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_experts"]
    return {
        "router": ("randn", (d, e), d ** -0.5),
        "w_gate": ("randn", (e, d, f), d ** -0.5),
        "w_up": ("randn", (e, d, f), d ** -0.5),
        "w_down": ("randn", (e, f, d), f ** -0.5),
    }


def expert_capacity(cfg: dict, n_tokens: int) -> int:
    """The port's bin size for a dispatch of ``n_tokens``: all of them at or
    below ``moe_exact_tokens``, else k x capacity_factor x n / E rounded up
    to 8."""
    if n_tokens <= cfg["moe_exact_tokens"]:
        return n_tokens
    c = int(n_tokens * cfg["num_experts_per_tok"] * cfg["capacity_factor"] / cfg["num_experts"])
    return max(8, -(-c // 8) * 8)


def moe_ffn(p: dict, cfg: dict, h: torch.Tensor, group: torch.Tensor, n_groups: int, prec: Precision):
    """h (T, d) tokens in dispatch order; group (T,) each token's dispatch
    group, all groups of one size. Returns (y (T, d), slots dropped)."""
    T, d = h.shape
    E, K = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(prec.mm(h, p["router"]), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = vals[:, :K], idx[:, :K]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = expert_capacity(cfg, T // n_groups)
    key = group.repeat_interleave(K) * E + gate_e.reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros((n_groups * E,), dtype=torch.int64, device=h.device).index_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    place = torch.empty_like(key)
    place[order] = torch.arange(T * K, device=h.device) - starts[key[order]]
    keep = place < cap
    flat_e, flat_w = gate_e.reshape(-1), gate_w.reshape(-1)
    y = torch.zeros((T, d), dtype=torch.float32, device=h.device)
    for e in range(E):
        slots = torch.nonzero(keep & (flat_e == e))[:, 0]
        if slots.numel() == 0:
            continue
        tok = slots // K
        x = h[tok]
        out = prec.mm(F.silu(prec.mm(x, p["w_gate"][e])) * prec.mm(x, p["w_up"][e]), p["w_down"][e])
        y = y.index_add(0, tok, out * flat_w[slots, None])
    return y, int((~keep).sum())


def forward(p: dict, cfg: dict, h: torch.Tensor, prec: Precision, prompt_len: int) -> tuple:
    """The port's dispatch groups in its token order: the prompt (b-major)
    in one, then one a decode step."""
    B, S, _ = h.shape
    Lp, steps = prompt_len, S - prompt_len
    y = torch.zeros_like(h)
    pre, dec = h[:, :Lp].reshape(B * Lp, -1), h[:, Lp:].transpose(0, 1).reshape(steps * B, -1)
    one = torch.zeros(B * Lp, dtype=torch.int64, device=h.device)
    y_pre, dropped = moe_ffn(p, cfg, pre, one, 1, prec)
    y[:, :Lp] = y_pre.view(B, Lp, -1)
    if steps:
        g_dec = torch.arange(steps, device=h.device).repeat_interleave(B)
        y_dec, d_dec = moe_ffn(p, cfg, dec, g_dec, steps, prec)
        y[:, Lp:] = y_dec.view(steps, B, -1).transpose(0, 1)
        dropped += d_dec
    return y, dropped


def products(cfg: dict, active: bool) -> int:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    experts = cfg["num_experts_per_tok"] if active else cfg["num_experts"]
    return d * cfg["num_experts"] + experts * 3 * d * f


def routed(cfg: dict) -> int:
    return cfg["num_experts_per_tok"]
