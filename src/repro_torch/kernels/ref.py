"""Plain PyTorch oracles for the port's kernels (port of ``repro.kernels.ref``).

Deliberately naive: full score matrices in f32. The kernel wrappers use them
for tensors on the CPU (the tests); on a card they are what ``chip_smoke.py``
holds each kernel against. Nothing on the serving path calls them when the
tensors lie on a card.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import NEG_INF


def _gqa_softmax_v(qg, k, v, ok, out_shape, dtype):
    """qg (B, Lq, KVH, gq, Dh); k/v (B, Lk, KVH, Dh); ok broadcastable to
    (B, KVH, gq, Lq, Lk)."""
    dh = qg.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (dh**-0.5)
    s = torch.where(ok, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(out_shape).to(dtype)


def reference_attention(
    q: torch.Tensor,  # (B, Lq, H, Dh)
    k: torch.Tensor,  # (B, Lk, KVH, Dh)
    v: torch.Tensor,  # (B, Lk, KVH, Dh)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    B, Lq, H, Dh = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Lq, KVH, H // KVH, Dh)
    q_pos = torch.arange(Lq, device=q.device)[:, None]
    k_pos = torch.arange(Lk, device=q.device)[None, :]
    ok = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    return _gqa_softmax_v(qg, k, v, ok, q.shape, q.dtype)


def reference_decode(
    q: torch.Tensor,  # (B, 1, H, Dh)
    k: torch.Tensor,  # (B, S, KVH, Dh)
    v: torch.Tensor,  # (B, S, KVH, Dh)
    k_pos: torch.Tensor,  # (B, S)
    q_pos: torch.Tensor,  # (B,)
    n_valid: torch.Tensor,  # (B,)
    *,
    window: int = 0,
) -> torch.Tensor:
    B, _, H, Dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, 1, KVH, H // KVH, Dh)
    slot = torch.arange(S, device=q.device)[None, :]
    ok = (k_pos <= q_pos[:, None]) & (slot < n_valid[:, None])
    if window > 0:
        ok &= k_pos > (q_pos[:, None] - window)
    return _gqa_softmax_v(qg, k, v, ok[:, None, None, None, :], q.shape, q.dtype)
