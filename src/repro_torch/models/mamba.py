"""Mamba-1 selective-state-space mixer (falcon-mamba / Jamba layers).

Port of ``repro.models.mamba``. Where the reference runs its chunked
associative ``selective_scan`` (or the Pallas kernel handed in as
``scan_impl``), the port calls ``kernels["mamba_scan"]`` (default
``repro_torch.kernels.ops.kernel_set()``), with the carry-in state ``h0`` and
``chunk_len``; the kernel and its plain version take the place of the chunked
scan. Where a gradient is needed (training; the reference's train step
differentiates its chunked scan), the call goes through ``MambaScan``, which
pairs it with ``kernels["mamba_scan_bwd"]``. Decode is the O(1) single-token
affine update plus a depthwise-conv window, in plain PyTorch as in the
reference.

Where the rules shard ``inner`` over a ``model`` axis of tp > 1, a rank
trains its Di/tp channels: the conv, ``dt_proj``, ``dt_bias``, ``a_log``, the
scan and ``d_skip`` are per channel. ``in_proj`` (d, 2 Di) is stored as the
rule says, contiguous over ``inner``, which gives rank 0 of 2 the x half and
rank 1 the z half; the block all-gathers it whole (its gradient
reduce-scattered back) and multiplies by its own x and z columns.
``x_proj`` is row-parallel, one all-reduce before dt, B and C (which enter
the local channels' products through ``to_model``); ``out_proj`` is
row-parallel, one all-reduce.

Serving (no gradient) keeps ``in_proj`` as its (d, 2, Di) view, whose shard
over ``inner`` is this rank's x and z columns ``[x_r | z_r]``
(``dist.step.serve_params`` makes the view; placed, each rank holds its
columns once, and no call gathers the weight). The decode and
prefill-into-state branches then run on the local channels, with the cached
(h, conv window) of those channels and ``x_proj`` row-parallel.

Decode writes the new (h, conv window) into the cache's tensors in place;
prefill returns new ones.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import kernel_set

from .common import ArchConfig, ParamBuilder, tensor_parallel


def init_mamba(pb: ParamBuilder, cfg: ArchConfig) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r, k = cfg.dt_rank, cfg.ssm_conv
    # S4D-real init for A; dt bias init so softplus(dt) spans [1e-3, 1e-1]
    a_init = np.tile(np.arange(1, n + 1, dtype=np.float32)[None, :], (di, 1))
    dt = np.exp(
        np.random.RandomState(0).uniform(np.log(1e-3), np.log(1e-1), size=(di,))
    ).astype(np.float32)
    dt_bias = dt + np.log1p(-np.exp(-dt))  # inverse softplus
    return {
        "in_proj": pb.dense((d, 2 * di), ("embed", "inner")),
        "conv_w": pb.dense((k, di), (None, "inner"), scale=k**-0.5),
        "conv_b": pb.zeros((di,), ("inner",)),
        "x_proj": pb.dense((di, r + 2 * n), ("inner", None)),
        "dt_proj": pb.dense((r, di), (None, "inner"), scale=r**-0.5),
        "dt_bias": pb.const(dt_bias, ("inner",), torch.float32),
        "a_log": pb.const(np.log(a_init), ("inner", None), torch.float32),
        "d_skip": pb.ones((di,), ("inner",)),
        "out_proj": pb.dense((di, d), ("inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, Di), w: (K, Di) -> (B, L, Di)."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):  # sum_k w[k] * x[t - (K-1) + k]
        out = out + w[k] * xp[:, k : k + L]
    return out + b


def _ssm_params(p: dict, cfg: ArchConfig, xc: torch.Tensor, par=None):
    """xc: (B, L, Di) post-conv activations -> dt (f32), Bmat, Cmat (f32)."""
    r, n = cfg.dt_rank, cfg.ssm_state
    proj = xc @ p["x_proj"]  # (B, L, r + 2n)
    if par is not None:  # partial sums over the local channels
        proj = par.to_model(par.from_model(proj))
    dt_in, Bm, Cm = proj[..., :r], proj[..., r : r + n], proj[..., r + n :]
    dt = (dt_in @ p["dt_proj"]).float()
    dt = F.softplus(dt + p["dt_bias"])  # (B, L, Di) f32
    return dt, Bm.float().contiguous(), Cm.float().contiguous()  # the scan takes contiguous B, C


class MambaScan(torch.autograd.Function):
    """(y, h_final) = mamba_scan(xc, dt, Bm, Cm, a, h0) with its gradient: the
    forward saves its inputs, the backward calls ``bwd`` on them and the
    cotangents of y and h_final (None where h_final is not used).

    ``fwd(xc, dt, Bm, Cm, a, h0=, chunk_len=) -> (y, h_final)`` and
    ``bwd(xc, dt, Bm, Cm, a, h0, dy, dh_final) -> (dxc, ddt, dB, dC, da,
    dh0)``: the kernels' wrappers, or their plain versions (``kernels.ref``)
    to hold the kernels against. Under activation checkpointing the forward
    runs again in the backward pass, and launches its kernel again."""

    @staticmethod
    def forward(ctx, xc, dt, Bm, Cm, a, h0, chunk_len: int, fwd, bwd):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xc, dt, Bm, Cm, a, h0)
        ctx.bwd = bwd
        return fwd(xc, dt, Bm, Cm, a, h0=h0, chunk_len=chunk_len)

    @staticmethod
    def backward(ctx, dy, dh):
        xc, dt, Bm, Cm, a, h0 = ctx.saved_tensors
        dy = torch.zeros_like(dt) if dy is None else dy.contiguous()
        dxc, ddt, dB, dC, da, dh0 = ctx.bwd(xc, dt, Bm, Cm, a, h0, dy, None if dh is None else dh.contiguous())
        return dxc, ddt, dB, dC, da, (None if h0 is None else dh0), None, None, None


def selective_scan(kernels: dict, xc, dt, Bm, Cm, a, h0=None, chunk_len: int = 256):
    """``kernels["mamba_scan"]``, through ``MambaScan`` with
    ``kernels["mamba_scan_bwd"]`` when a gradient is needed."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (xc, dt, Bm, Cm, a, h0)):
        return MambaScan.apply(xc, dt, Bm, Cm, a, h0, chunk_len, kernels["mamba_scan"], kernels["mamba_scan_bwd"])
    return kernels["mamba_scan"](xc, dt, Bm, Cm, a, h0=h0, chunk_len=chunk_len)


def mamba_block(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, L, D)
    positions: torch.Tensor,  # unused (kept for the mixer-uniform signature)
    cache: Optional[dict] = None,  # {"h": (B, Di, N) f32, "conv": (B, K-1, Di)}
    kernels: Optional[dict] = None,
):
    """Returns (y (B, L, D), new_cache); new_cache is None without a cache."""
    kernels = kernels or kernel_set()
    L, K = x.shape[1], cfg.ssm_conv
    par = tensor_parallel()
    par = par if par is not None and par.sharded("inner") else None
    if p["in_proj"].dim() == 3:  # the serve view (d, 2, Di): this rank's [x_r | z_r]
        w = p["in_proj"]
        xr, z = ((x if par is None else par.to_model(x)) @ w.reshape(w.shape[0], -1)).chunk(2, dim=-1)
    elif par is None:
        xr, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    else:
        from repro_torch.dist.comm import gather

        w = gather(p["in_proj"], par.comm, 1, ("model",))  # (d, 2 Di)
        di = w.shape[1] // 2
        xr, z = (par.to_model(x) @ torch.cat([par.model_slice(w[:, :di], 1), par.model_slice(w[:, di:], 1)],
                                             dim=1)).chunk(2, dim=-1)
    a = -torch.exp(p["a_log"])  # (Di, N)

    if cache is None:
        xc = F.silu(_causal_conv(xr, p["conv_w"], p["conv_b"]))
        dt, Bm, Cm = _ssm_params(p, cfg, xc, par)
        y, _ = selective_scan(kernels, xc, dt, Bm, Cm, a, chunk_len=min(256, L))
        new_cache = None
    elif L == 1:
        # decode: single-token affine update, written into the cache's own
        # tensors (a CUDA graph replays the step against the same buffers)
        conv_win = torch.cat([cache["conv"], xr], dim=1)  # (B, K, Di)
        xc = F.silu(torch.einsum("bkd,kd->bd", conv_win, p["conv_w"]) + p["conv_b"])[:, None]
        dt, Bm, Cm = _ssm_params(p, cfg, xc, par)
        h = torch.exp(dt[:, 0, :, None] * a) * cache["h"] + (dt[:, 0] * xc[:, 0].float())[
            ..., None
        ] * Bm[:, 0, None, :]
        y = torch.einsum("bin,bn->bi", h, Cm[:, 0])[:, None]  # (B, 1, Di)
        cache["h"].copy_(h)
        cache["conv"].copy_(conv_win[:, 1:])
        new_cache = {"h": cache["h"], "conv": cache["conv"]}
    else:
        # prefill into an existing state: conv seeded from the cached window,
        # scan seeded from the cached h
        conv_in = torch.cat([cache["conv"], xr], dim=1)  # (B, K-1+L, Di)
        acc = torch.zeros_like(xr)
        for k in range(K):
            acc = acc + p["conv_w"][k] * conv_in[:, k : k + L]
        xc = F.silu(acc + p["conv_b"])
        dt, Bm, Cm = _ssm_params(p, cfg, xc, par)
        y, h_final = selective_scan(kernels, xc, dt, Bm, Cm, a, cache["h"], chunk_len=min(256, L))
        new_cache = {"h": h_final, "conv": conv_in[:, -(K - 1) :]}

    y = y + xcf_skip(xc, p["d_skip"])
    y = (y * F.silu(z.float())).to(x.dtype)
    y = y @ p["out_proj"]
    return (y if par is None else par.from_model(y)), new_cache


def xcf_skip(xc: torch.Tensor, d_skip: torch.Tensor) -> torch.Tensor:
    return xc.float() * d_skip


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
    }
