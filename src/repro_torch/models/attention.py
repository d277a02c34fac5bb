"""Attention mixer: full / sliding-window GQA with QKV bias and a KV cache.

Port of the standard attention block of ``repro.models.attention``. Where the
JAX package computes attention in jnp (``blocked_attention`` for train and
prefill, ``_cached_attention`` for decode), the port calls the kernels of the
``kernels`` dict it is handed (default ``repro_torch.kernels.ops.kernel_set()``):
``flash_attention`` for the no-cache and prefill branches, ``flash_decode``
for decode. Where a gradient is needed (training), the no-cache branch goes
through ``FlashAttention``, a ``torch.autograd.Function`` that pairs the
forward kernel (with its log-sum-exp) and ``flash_attention_bwd`` (K1); under
``inference_mode`` it calls the forward alone. Not ported yet: SWA ring
caches, cross-attention and MLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ops import kernel_set

from .common import ArchConfig, ParamBuilder, apply_rope


def init_attention(pb: ParamBuilder, cfg: ArchConfig) -> dict:
    d, H, KVH, Dh = cfg.d_model, cfg.n_heads_eff, cfg.n_kv_heads, cfg.head_dim
    if H % KVH:
        raise ValueError(f"padded heads {H} must stay a multiple of kv={KVH}")
    # Scaled by the true fan-in (d for wq/wk/wv, H*Dh for wo). The reference's
    # ParamBuilder.dense takes shape[-2] (H, KVH, Dh) for these 3-D weights,
    # which gives attention logits of std ~64 at init: a random model whose
    # full depth amplifies any rounding difference until its outputs decorrelate.
    p = {
        "wq": pb.dense((d, H, Dh), scale=d**-0.5),
        "wk": pb.dense((d, KVH, Dh), scale=d**-0.5),
        "wv": pb.dense((d, KVH, Dh), scale=d**-0.5),
        "wo": pb.dense((H, Dh, d), scale=(H * Dh) ** -0.5),
    }
    if cfg.pad_heads:
        p["wo"][cfg.n_heads:] = 0
    if cfg.qkv_bias:
        p["bq"] = pb.zeros((H, Dh))
        p["bk"] = pb.zeros((KVH, Dh))
        p["bv"] = pb.zeros((KVH, Dh))
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bld,dhk->blhk') as one matmul."""
    B, L, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, L, *w.shape[1:])


def _project_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    # RoPE on q/k: every head of a token rotates by that token's position
    q = apply_rope(q, positions[:, :, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, :, None], cfg.rope_theta)
    return q, k, v


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with its gradient: the forward saves q, k, v, o
    and the row log-sum-exp, the backward calls ``bwd`` on them.

    ``fwd(q, k, v, causal=, window=, return_lse=True) -> (o, lse)`` and
    ``bwd(q, k, v, o, do, lse, causal=, window=) -> (dq, dk, dv)``: the
    kernels' wrappers, or their plain versions (``kernels.ref``) to hold the
    kernels against. Under activation checkpointing the forward runs again in
    the backward pass, and launches its kernel again."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, fwd, bwd):
        o, lse = fwd(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.bwd = causal, window, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, do.contiguous(), lse, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, causal: bool, window: int, kernels: dict) -> torch.Tensor:
    """``kernels["flash_attention"]``, through ``FlashAttention`` with
    ``kernels["flash_attention_bwd"]`` when a gradient is needed."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, kernels["flash_attention"],
                                    kernels["flash_attention_bwd"])
    return kernels["flash_attention"](q, k, v, causal=causal, window=window)


def attention_block(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, L, D)
    positions: torch.Tensor,  # (B, L) absolute positions
    cache: Optional[dict] = None,  # see init_attention_cache
    cross_kv: Optional[tuple] = None,
    kernels: Optional[dict] = None,
):
    """Self-attention with optional KV cache — returns (y, new_cache).

    The cache's K/V are written in place (the JAX step donates its buffers
    instead); ``new_cache`` holds the same tensors and the advanced index,
    a host ``int``, so decode never waits on the device for it."""
    if cross_kv is not None:
        raise NotImplementedError("cross-attention is not ported yet (see ROADMAP.md queue 1)")
    kernels = kernels or kernel_set()
    B, L, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    window = cfg.window if cfg.attention == "swa" else 0

    if cache is None:
        out = attention(q, k, v, causal=True, window=window, kernels=kernels)
        new_cache = None
    else:
        idx = cache["index"]
        ck, cv = cache["k"], cache["v"]
        S = ck.shape[1]
        if idx + L > S:
            raise ValueError(f"KV cache full: {idx} + {L} tokens > {S} slots")
        ck[:, idx : idx + L] = k
        cv[:, idx : idx + L] = v
        total = idx + L
        if L > 1:
            # prefill over the whole cache: slots >= L are causally dead only
            # for a fresh cache, so prefill starts at index 0, as in JAX
            if idx != 0:
                raise ValueError(f"prefill must start from an empty cache, not index {idx}")
            out = kernels["flash_attention"](q, ck, cv, causal=True, window=window)
        else:
            dev = x.device
            k_pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
            q_pos = positions[:, 0].to(torch.int32)
            n_valid = torch.full((B,), total, dtype=torch.int32, device=dev)
            out = kernels["flash_decode"](q, ck, cv, k_pos, q_pos, n_valid, window=window)
        new_cache = {"k": ck, "v": cv, "index": total}

    H, Dh = out.shape[2], out.shape[3]
    y = out.reshape(B, L, H * Dh) @ p["wo"].reshape(H * Dh, -1)
    return y, new_cache


def init_attention_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> dict:
    if cfg.attention == "swa" and cfg.window and max_len >= cfg.window:
        raise NotImplementedError(
            "SWA ring-buffer caches are not ported yet (see ROADMAP.md queue 1)"
        )
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }
