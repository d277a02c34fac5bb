"""Multi-head latent attention (MiniCPM3, DeepSeek-V2 style): the port's
``models/attention.py::init_mla`` and ``mla_block`` (attention ``"mla"``).

    cq = rms(x W_qa) * q_norm;  q = cq W_qb, split into nope (dn) and rope (dr) parts, RoPE on the latter
    x W_kva = [c ‖ r];  c_kv = rms(c) * kv_norm;  k_rope = RoPE(r), one for all heads
    K = [c_kv W_kb ‖ k_rope],  V = c_kv W_vb
    causal softmax(q K^T (dn + dr)**-0.5) V, then W_o

The reference computes this plain form, per-head K and V rebuilt from the
latents, in blocks of heads and of query rows. The port decodes with the
absorbed form over its latent cache (q_nope W_kb against c_kv, the latent
output through W_vb), so each comparison of served tokens also checks the
absorption.
"""

from __future__ import annotations

import torch

from portbench.reference.model import Precision, rms, rope

SLOT = "mixer"


def runs(spec, cfg) -> bool:
    return spec.mixer == "attention" and cfg.attention == "mla"


KEYS = {
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads", "rope_theta": "rope_theta",
    "q_lora_rank": "q_lora_rank", "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_dim",
    "qk_rope_head_dim": "qk_rope_dim", "v_head_dim": "v_head_dim",
}


def _sizes(cfg: dict) -> tuple:
    return (cfg["hidden_size"], cfg["num_attention_heads"], cfg["q_lora_rank"], cfg["kv_lora_rank"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def plan(cfg: dict) -> dict:
    d, H, qr, kvr, dn, dr, dv = _sizes(cfg)
    return {
        "wq_a": ("randn", (d, qr), d ** -0.5),
        "q_norm": ("ones", (qr,)),
        "wq_b": ("randn", (qr, H, dn + dr), qr ** -0.5),
        "wkv_a": ("randn", (d, kvr + dr), d ** -0.5),
        "kv_norm": ("ones", (kvr,)),
        "wk_b": ("randn", (kvr, H, dn), kvr ** -0.5),
        "wv_b": ("randn", (kvr, H, dv), kvr ** -0.5),
        "wo": ("randn", (H, dv, d), (H * dv) ** -0.5),
    }


def _attend(q, k, v, prec: Precision, head_block: int, row_block: int):
    """Causal softmax(q k^T / sqrt(Dk)) v over one K and V a head; q, k (B,
    S, H, Dk), v (B, S, H, Dv). A block of ``row_block`` query rows reads the
    keys up to its last row only, and masks the square at its end."""
    B, S, H, Dk = q.shape
    out = torch.empty((B, S, H, v.shape[-1]), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h0 in range(0, H, head_block):
            hs = slice(h0, min(H, h0 + head_block))
            qb, kb, vb = (prec.q(t[b, :, hs].transpose(0, 1)) for t in (q, k, v))  # (h, S, D)
            for r0 in range(0, S, row_block):
                r1 = min(S, r0 + row_block)
                s = torch.matmul(qb[:, r0:r1], kb[:, :r1].transpose(1, 2)) * Dk ** -0.5  # (h, rows, r1)
                dead = torch.ones((r1 - r0, r1 - r0), dtype=torch.bool, device=q.device).triu(1)
                s[:, :, r0:r1].masked_fill_(dead, float("-inf"))
                p = torch.softmax(s, dim=-1)
                out[b, r0:r1, hs] = torch.matmul(prec.q(p), vb[:, :r1]).transpose(0, 1)
    return out


def mla(p: dict, cfg: dict, h: torch.Tensor, prec: Precision, head_block: int = 20, row_block: int = 1024):
    B, S, _ = h.shape
    d, H, qr, kvr, dn, dr, dv = _sizes(cfg)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    pos = torch.arange(S, device=h.device)
    cq = rms(prec.mm(h, p["wq_a"]), p["q_norm"], eps)
    q = prec.mm(cq, p["wq_b"].reshape(qr, H * (dn + dr))).view(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, theta)], dim=-1)
    ckv = prec.mm(h, p["wkv_a"])
    c_kv = rms(ckv[..., :kvr], p["kv_norm"], eps)
    k_rope = rope(ckv[..., None, kvr:], pos, theta)  # (B, S, 1, dr)
    k_nope = prec.mm(c_kv, p["wk_b"].reshape(kvr, H * dn)).view(B, S, H, dn)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    v = prec.mm(c_kv, p["wv_b"].reshape(kvr, H * dv)).view(B, S, H, dv)
    del cq, ckv, c_kv, k_nope
    o = _attend(q, k, v, prec, head_block, row_block)
    return prec.mm(o.reshape(B, S, H * dv), p["wo"].reshape(H * dv, d))


def forward(p: dict, cfg: dict, h: torch.Tensor, prec: Precision, prompt_len: int) -> tuple:
    return mla(p, cfg, h, prec), 0


# ---------------------------------------------------------------------------
# Costs: at prefill the plain form, at decode the absorbed one, each the
# less work at its phase (at prefill per head a causal pair costs 2 (Dk +
# Dv) = 320 operations, absorbed 2 (2 kvr + dr) = 1088; at decode rebuilding
# per-head K and V over the context costs 2 kvr H (dn + dv) a slot). So
# decode_mfu.serve and attn_roofline.prefill read the same work whatever
# form computes it. W_kb and W_vb multiply once a token in either form, and
# count among the products.
# ---------------------------------------------------------------------------


def products(cfg: dict, active: bool) -> int:
    d, H, qr, kvr, dn, dr, dv = _sizes(cfg)
    return d * qr + qr * H * (dn + dr) + d * (kvr + dr) + kvr * H * (dn + dv) + H * dv * d


def attention_shape(cfg: dict) -> tuple:
    """Per-head K and V: as many KV heads as query heads."""
    _, H, _, _, dn, dr, dv = _sizes(cfg)
    return H, H, dn + dr, dv


def decode_extra(cfg: dict, B: int, context: int, elt: int) -> tuple:
    """The absorbed products (scores over the latent and the rotary key, the
    latent output) over the context, and the latent cache read once."""
    _, H, _, kvr, _, dr, _ = _sizes(cfg)
    return 2 * B * H * context * (2 * kvr + dr), B * context * (kvr + dr) * elt
