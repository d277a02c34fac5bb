"""Int8 error-feedback gradient compression for the cross-pod reduction.

Port of ``repro.optim.compress``, with the reference's arithmetic: each
pod quantises (grad + residual) to int8 with a per-tensor scale
(max |x| / 127), the int8 values are summed over the pods, the scales too,
and the mean gradient is the sum times the mean scale over the number of
pods; the new residual is what this pod's quantisation lost, fed back into
the next step's gradient.

The reference sums the int8 values on an int16 wire (2 bytes a parameter).
Neither NCCL nor gloo reduces int16, so the port packs two values, each
biased by +127 into [0, 254], into one int32 lane and sums the lanes: for up
to 258 pods a half's sum stays below 2**16, so no carry crosses the halves
(the upper half's signed wrap is harmless modulo 2**32); unbiasing subtracts
n * 127. The integer sums are the reference's, on the same 2 bytes a
parameter. ``ef_compress`` takes every leaf's payload in one collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .adamw import tree_leaves, tree_map

BIAS = 127
MAX_PODS = (2**16 - 1) // (2 * BIAS)  # 258: a half-lane's sum stays below 2**16


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8. Returns (q int8, scale f32 scalar)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_state_init(grads) -> dict:
    """Error-feedback residual tree (f32, zero-init)."""
    return {"residual": tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)}


def pack_int8_pairs(q: torch.Tensor) -> torch.Tensor:
    """Flat int8 (n,) -> int32 (ceil(n / 2),): value 2i + 127 in the low half
    of lane i, value 2i + 1 + 127 in the high half."""
    u = q.to(torch.int32) + BIAS
    if u.numel() % 2:
        u = torch.cat([u, u.new_full((1,), BIAS)])
    u = u.view(-1, 2)
    return u[:, 0] | (u[:, 1] << 16)


def unpack_int32_sums(lanes: torch.Tensor, n: int, n_pods: int) -> torch.Tensor:
    """Summed lanes of ``n_pods`` packs -> the (n,) int32 sums of the values."""
    lo = lanes & 0xFFFF
    hi = (lanes >> 16) & 0xFFFF
    return torch.stack([lo, hi], dim=1).reshape(-1)[:n] - n_pods * BIAS


def sum_int8(q: torch.Tensor, group, n_pods: int) -> torch.Tensor:
    """The int32 sums over the pods of ``group`` (None for one pod) of a
    flat int8 payload, carried two values to an int32 lane."""
    if not 1 <= n_pods <= MAX_PODS:
        raise ValueError(f"{n_pods} pods: the packed int8 sums hold 1 to {MAX_PODS}")
    lanes = pack_int8_pairs(q)
    if group is not None:
        dist.all_reduce(lanes, group=group)
    return unpack_int32_sums(lanes, q.numel(), n_pods)


def ef_compress(grads, state: dict, group, n_pods: int):
    """Quantise (grad + residual) per leaf, sum the int8 payloads over the
    pods of ``group`` (a process group, None for one pod) packed two to an
    int32 lane, sum the scales, and dequantise the mean. Returns
    (reduced_grads, new_state, stats): the grads in their own dtypes, the new
    residuals, and ``compress_ratio`` (the reference's f32 / int8 bytes)
    beside ``wire_bytes_per_param``, the bytes a parameter puts on the pod
    links."""
    flat_g = tree_leaves(grads)
    flat_r = tree_leaves(state["residual"])
    gfs, qs, scales = [], [], []
    for g, r in zip(flat_g, flat_r):
        gf = g.float() + r
        q, scale = quantize_int8(gf)
        gfs.append(gf)
        qs.append(q)
        scales.append(scale)
    q_all = torch.cat([q.reshape(-1) for q in qs])
    qsum = sum_int8(q_all, group, n_pods)
    ssum = torch.stack(scales)
    if group is not None:
        dist.all_reduce(ssum, group=group)
    mean_scale = ssum / n_pods
    out_g, out_r = [], []
    off = 0
    for g, gf, q, scale, ms in zip(flat_g, gfs, qs, scales, mean_scale):
        n = q.numel()
        g_hat = qsum[off : off + n].view(q.shape).float() * ms / n_pods
        off += n
        out_g.append(g_hat.to(g.dtype))
        out_r.append(gf - dequantize_int8(q, scale))
    ig, ir = iter(out_g), iter(out_r)
    bytes_fp32 = sum(g.numel() * 4 for g in flat_g)
    bytes_int8 = sum(g.numel() for g in flat_g)
    return tree_map(lambda _: next(ig), grads), {"residual": tree_map(lambda _: next(ir), grads)}, {
        "compress_ratio": bytes_fp32 / max(bytes_int8, 1),
        "wire_bytes_per_param": 4 * -(-q_all.numel() // 2) / max(bytes_int8, 1),
    }
