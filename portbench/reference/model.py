"""The plain reference of the benchmark's models: PyTorch in f32, TF32 off.

It imports nothing of the port. It follows the port's layer equations
(``repro_torch/models``), taken from the configuration file's sizes alone:
RMSNorm, the q, k and v biases where the file sets ``use_qkv_bias``,
split-half RoPE, causal GQA attention with scale Dh**-0.5, SwiGLU, top-k
routing from an f32 softmax (a stable descending sort; the k weights
renormalised) with the port's capacity rule and its drops (a token-slot is
kept iff its place in its expert's bin, in token-major order within its
dispatch group, is below the group's capacity), and Mamba-1 (depthwise
causal conv, softplus dt, the sequential scan, the D skip, the z gate).

Every matrix product goes through a ``Precision``: ``"f32"`` is the
reference; ``"fp8"`` rounds both operands of every product to float8 e4m3
with one scale per tensor first: the control, the reference computed in the
precision below the configuration's bf16; ``"bf16"`` rounds both operands
to bf16, a witness of what the configuration's own precision alone does.

Weights arrive in their stored dtype and are widened to f32 a layer at a
time (an expert at a time), so a model's f32 weights are never all held.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def strict_f32() -> None:
    """Matrix products in full f32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one scale (its amax at 448), back in f32."""
    s = x.abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(FP8).to(torch.float32) * s


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., K) @ b (K, N) in f32, or on e4m3-rounded operands."""
        a, b = a.float(), b.float()
        if self.mode == "f32":
            return a @ b
        if self.mode == "bf16":
            return (a.bfloat16() @ b.bfloat16()).float()
        return fp8_round(a) @ fp8_round(b)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of attention's batched products, as ``mm`` takes it."""
        if self.mode == "bf16":
            return x.bfloat16().float()
        return x if self.mode == "f32" else fp8_round(x)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh), positions (S,): the halves of Dh form the pairs."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = positions.float()[:, None] * freqs  # (S, dh/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


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


def dense_ffn(p: dict, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(h, p["w_gate"])) * prec.mm(h, p["w_up"]), p["w_down"])


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
    group (a prefill, or one decode step), all groups of one size. Returns
    (y (T, d), slots dropped)."""
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


def layer_kinds(cfg: dict) -> list:
    layout = cfg["layout"]
    return [layout[i % len(layout)] for i in range(cfg["num_hidden_layers"])]


# ---------------------------------------------------------------------------
# Serving: the logits of every served token, teacher-forced
# ---------------------------------------------------------------------------


@torch.no_grad()
def served_logits(cfg: dict, params: dict, prompts: torch.Tensor, served: torch.Tensor,
                  prec: Precision) -> tuple:
    """The logits (B, G, V) that pick each of the G served tokens of a round:
    the prompts (B, Lp) prefilled in one dispatch group, then each generated
    token but the last fed one decode step at a time (a dispatch group of B
    tokens each). Returns (logits, slots dropped by the capacity rule)."""
    B, Lp = prompts.shape
    G = served.shape[1]
    tokens = torch.cat([prompts, served[:, :-1]], dim=1).long()
    S = tokens.shape[1]
    eps = cfg["rms_norm_eps"]
    x = params["embed"][tokens].float()  # (B, S, d)
    # dispatch groups in the port's token order: the prompt (b-major) in one, then one a decode step
    dropped = 0
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        h = rms(x, p["ln1"], eps)
        mixer = attention if kind["mixer"] == "attention" else mamba
        x = x + mixer(p["mixer"], cfg, h, prec)
        h = rms(x, p["ln2"], eps)
        if kind["ffn"] == "moe":
            y = torch.zeros_like(x)
            pre, dec = h[:, :Lp].reshape(B * Lp, -1), h[:, Lp:].transpose(0, 1).reshape((G - 1) * B, -1)
            one = torch.zeros(B * Lp, dtype=torch.int64, device=h.device)
            y_pre, d_pre = moe_ffn(p["ffn"], cfg, pre, one, 1, prec)
            y[:, :Lp] = y_pre.view(B, Lp, -1)
            if G > 1:
                g_dec = torch.arange(G - 1, device=h.device).repeat_interleave(B)
                y_dec, d_dec = moe_ffn(p["ffn"], cfg, dec, g_dec, G - 1, prec)
                y[:, Lp:] = y_dec.view(G - 1, B, -1).transpose(0, 1)
                dropped += d_dec
            dropped += d_pre
            x = x + y
        else:
            x = x + dense_ffn(p["ffn"], h, prec)
    xs = rms(x[:, Lp - 1 :], params["final_norm"], eps)
    head = params["embed"].T if cfg.get("tie_word_embeddings") else params["lm_head"]
    return prec.mm(xs, head), dropped


def logit_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the reference's best, (B, G)."""
    ref_logits = ref_logits.float()
    return ref_logits.amax(-1) - ref_logits.gather(-1, tokens.long()[..., None])[..., 0]
