"""Feed-forward blocks: the dense SwiGLU FFN and the routed MoE FFN.

Port of ``repro.models.moe``. The MoE FFN keeps the reference's static
sort-based dispatch:

  1. router (in f32): softmax over experts, top-k (weight, expert) per token
     in ``jax.lax.top_k``'s order (ties: lowest expert index first);
  2. dispatch: stable-sort the token-slots by expert, keep the first C per
     expert (overflow goes to the dump slot ``E*C`` and is dropped), scatter
     the token vectors into an (E, C, D) buffer;
  3. grouped SwiGLU per expert over its capacity bin, through
     ``kernels["moe_gmm"]``; where a gradient is needed, through ``MoeGmm``,
     which pairs it with ``kernels["moe_gmm_bwd"]`` (the reference's train
     step differentiates its einsums, ``repro/models/moe.py:127-131``);
  4. combine: gather each slot's output back, weight, and sum over k.

Group-local dispatch (``moe_groups > 1``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import kernel_set

from .common import ArchConfig, ParamBuilder


def init_moe(pb: ParamBuilder, cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": pb.dense((d, e), scale=d**-0.5),
        "w_gate": pb.dense((e, d, f)),
        "w_up": pb.dense((e, d, f)),
        "w_down": pb.dense((e, f, d)),
    }


def expert_capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Per-expert capacity bin size for an n_tokens dispatch call: n_tokens
    (drop-free) at or below ``cfg.moe_exact_tokens``, else proportional to
    ``capacity_factor`` and rounded up to 8, with overflow dropped."""
    if n_tokens <= cfg.moe_exact_tokens:
        return n_tokens
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(p: dict, cfg: ArchConfig, xf: torch.Tensor):
    """xf (T, D) -> (probs (T, E) f32, gate_w (T, K) f32 renormalised,
    gate_e (T, K) int64). A stable descending sort gives ``lax.top_k``'s
    order, ties included; ``torch.topk`` leaves the order of ties open."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = vals[:, : cfg.top_k], idx[:, : cfg.top_k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_e


def _dispatch(xf: torch.Tensor, gate_e: torch.Tensor, K: int, E: int, C: int):
    """xf (T, D), gate_e (T, K) -> (xe (E, C, D), slot_by_flat (T*K,), kept)
    where slot ``E*C`` is the overflow dump."""
    T, D = xf.shape
    flat_e = gate_e.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * K, device=xf.device) - starts[sorted_e]
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    xbuf = torch.zeros((E * C + 1, D), dtype=xf.dtype, device=xf.device)
    xbuf[dest] = xf[sort_idx // K]  # kept slots are distinct; the dump row is discarded
    slot_by_flat = torch.empty_like(dest)
    slot_by_flat[sort_idx] = dest
    return xbuf[: E * C].view(E, C, D), slot_by_flat, keep.sum()


class MoeGmm(torch.autograd.Function):
    """out = moe_gmm(x, w_gate, w_up, w_down) with its gradient: the forward
    saves its inputs, the backward calls ``bwd`` on them and the output's
    cotangent.

    ``fwd(x, w_gate, w_up, w_down) -> out`` and ``bwd(x, w_gate, w_up,
    w_down, dy) -> (dx, dwg, dwu, dwd)``: the kernels' wrappers, or their
    plain versions (``kernels.ref``) to hold the kernels against. Under
    activation checkpointing the forward runs again in the backward pass, and
    launches its kernel again."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, fwd, bwd):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        ctx.bwd = bwd
        return fwd(x, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dy):
        return (*ctx.bwd(*ctx.saved_tensors, dy.contiguous()), None, None)


def grouped_swiglu(x, w_gate, w_up, w_down, kernels: dict) -> torch.Tensor:
    """``kernels["moe_gmm"]``, through ``MoeGmm`` with ``kernels["moe_gmm_bwd"]``
    when a gradient is needed."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_gate, w_up, w_down)):
        return MoeGmm.apply(x, w_gate, w_up, w_down, kernels["moe_gmm"], kernels["moe_gmm_bwd"])
    return kernels["moe_gmm"](x, w_gate, w_up, w_down)


def moe_ffn(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, L, D)
    kernels: Optional[dict] = None,
):
    """Returns (y (B, L, D), {"aux_loss", "dropped_frac"}), both f32 scalars."""
    if cfg.moe_groups > 1:
        raise NotImplementedError(
            "group-local MoE dispatch (moe_groups > 1) is not ported yet "
            "(see ROADMAP.md queue 1, Distribution)"
        )
    kernels = kernels or kernel_set()
    B, L, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * L
    C = expert_capacity(T, cfg)
    xf = x.reshape(T, D)

    probs, gate_w, gate_e = route(p, cfg, xf)
    # Switch aux loss: E * sum_e (top-1 token fraction_e * mean prob_e)
    onehot = F.one_hot(gate_e[:, 0], E).float()
    aux_loss = E * torch.mean(probs.mean(0) * onehot.mean(0))

    xe, slot_by_flat, kept = _dispatch(xf, gate_e, K, E, C)
    h = grouped_swiglu(xe, p["w_gate"], p["w_up"], p["w_down"], kernels)  # (E, C, D)

    ybuf = torch.cat([h.reshape(E * C, D), h.new_zeros((1, D))])
    y = ybuf[slot_by_flat].view(T, K, D)
    y = (y * gate_w[..., None].to(y.dtype)).sum(dim=1)
    dropped = T * K - kept
    return y.view(B, L, D).to(x.dtype), {
        "aux_loss": aux_loss,
        "dropped_frac": dropped.float() / (T * K),
    }


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
