"""GQA attention with optional q, k and v biases: the port's
``models/attention.py::init_attention`` and ``attention_block`` (attention
``"full"``). RoPE rotates the halves of the whole head (split-half), the
causal softmax is at scale Dh**-0.5, Dh = hidden_size / heads."""

from __future__ import annotations

import torch

from portbench import blocks
from portbench.reference.model import Precision, rope

SLOT = "mixer"


def runs(spec, cfg) -> bool:
    return spec.mixer == "attention" and cfg.attention == "full"


KEYS = {
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads", "rope_theta": "rope_theta",
    "partial_rotary_factor": lambda cfg: 1.0,  # the port rotates the whole head
    "attn_layer_period": lambda cfg: blocks.port_period(runs, cfg)[0],
    "attn_layer_offset": lambda cfg: blocks.port_period(runs, cfg)[1],
}
OPTIONS = {"use_qkv_bias": "qkv_bias"}
BIAS_SCALE = 0.1  # q, k and v biases: drawn, not zero, so that the comparison sees them


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def refuse(config: dict, cfg) -> list:
    wrong = []
    if cfg.head_dim != head_dim(config):
        wrong.append(f"head_dim: file hidden_size / num_attention_heads {head_dim(config)}, port {cfg.head_dim}")
    if cfg.qkv_bias and not config.get("use_qkv_bias"):
        wrong.append("the port's attention has q, k and v biases the cell's file does not state")
    return wrong


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def plan(cfg: dict) -> dict:
    d, H, KVH, Dh = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    p = {
        "wq": ("randn", (d, H, Dh), d ** -0.5),
        "wk": ("randn", (d, KVH, Dh), d ** -0.5),
        "wv": ("randn", (d, KVH, Dh), d ** -0.5),
        "wo": ("randn", (H, Dh, d), (H * Dh) ** -0.5),
    }
    if cfg.get("use_qkv_bias"):
        p |= {"bq": ("randn", (H, Dh), BIAS_SCALE), "bk": ("randn", (KVH, Dh), BIAS_SCALE),
              "bv": ("randn", (KVH, Dh), BIAS_SCALE)}
    return p


# ---------------------------------------------------------------------------
# The plain forward
# ---------------------------------------------------------------------------


def _attend(q, k, v, prec: Precision, head_block: int):
    """Causal softmax(q k^T / sqrt(Dh)) v; q (B, S, H, Dh), k, v (B, S, KVH,
    Dh); in blocks of ``head_block`` query heads a batch row."""
    B, S, H, Dh = q.shape
    g = H // k.shape[2]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    rows = []
    for b in range(B):
        outs = []
        for h0 in range(0, H, head_block):
            hs = torch.arange(h0, min(H, h0 + head_block), device=q.device)
            qb, kb, vb = prec.q(q[b][:, hs]), prec.q(k[b][:, hs // g]), prec.q(v[b][:, hs // g])
            s = torch.einsum("qhd,khd->hqk", qb, kb) * Dh ** -0.5
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            outs.append(torch.einsum("hqk,khd->qhd", prec.q(p), vb))
        rows.append(torch.cat(outs, dim=1))
    return torch.stack(rows)


def attention(p: dict, cfg: dict, h: torch.Tensor, prec: Precision, head_block: int = 8) -> torch.Tensor:
    B, S, d = h.shape
    H, KVH, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    pos = torch.arange(S, device=h.device)
    theta = cfg["rope_theta"]
    q = prec.mm(h, p["wq"].reshape(d, H * Dh)).view(B, S, H, Dh)
    k = prec.mm(h, p["wk"].reshape(d, KVH * Dh)).view(B, S, KVH, Dh)
    v = prec.mm(h, p["wv"].reshape(d, KVH * Dh)).view(B, S, KVH, Dh)
    if cfg.get("use_qkv_bias"):
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), v + p["bv"].float()
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    o = _attend(q, k, v, prec, head_block)
    return prec.mm(o.reshape(B, S, H * Dh), p["wo"].reshape(H * Dh, d))


def forward(p: dict, cfg: dict, h: torch.Tensor, prec: Precision, prompt_len: int) -> tuple:
    return attention(p, cfg, h, prec), 0


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------


def products(cfg: dict, active: bool) -> int:
    d, dh = cfg["hidden_size"], head_dim(cfg)
    return 2 * d * cfg["num_attention_heads"] * dh + 2 * d * cfg["num_key_value_heads"] * dh


def attention_shape(cfg: dict) -> tuple:
    dh = head_dim(cfg)
    return cfg["num_attention_heads"], cfg["num_key_value_heads"], dh, dh


def decode_extra(cfg: dict, B: int, context: int, elt: int) -> tuple:
    """The products of q with the cached K and V, and those K and V read."""
    H, KVH, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    return 4 * B * context * H * dh, 2 * B * context * KVH * dh * elt
