"""Plain PyTorch oracles for the port's kernels (port of ``repro.kernels.ref``).

Deliberately naive: full score matrices in f32, dense per-expert products,
a direct sequential scan over time. The kernel wrappers use them
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


def reference_gmm(
    x: torch.Tensor,  # (E, C, D) per-expert token bins
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
) -> torch.Tensor:
    """Per-expert SwiGLU: ``silu(x Wg) * (x Wu)`` in f32, cast to x's dtype,
    then ``@ Wd`` in f32, cast to x's dtype -- where the Pallas kernel casts.
    Returns (E, C, D)."""
    f32 = torch.float32
    g = torch.einsum("ecd,edf->ecf", x.to(f32), w_gate.to(f32))
    u = torch.einsum("ecd,edf->ecf", x.to(f32), w_up.to(f32))
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return torch.einsum("ecf,efd->ecd", h.to(f32), w_down.to(f32)).to(x.dtype)


def reference_selective_scan(
    xc: torch.Tensor,  # (B, L, Di)
    dt: torch.Tensor,  # (B, L, Di) f32 (post-softplus)
    Bm: torch.Tensor,  # (B, L, N) f32
    Cm: torch.Tensor,  # (B, L, N) f32
    a: torch.Tensor,  # (Di, N) f32 negative
    h0: torch.Tensor | None = None,  # (B, Di, N) f32
):
    """Direct sequential scan over time. Returns (y (B, L, Di) f32, h_final
    (B, Di, N) f32)."""
    B, L, Di = xc.shape
    N = a.shape[1]
    h = torch.zeros((B, Di, N), dtype=torch.float32, device=xc.device) if h0 is None else h0.float()
    xcf = xc.float()
    ys = []
    for t in range(L):
        h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * xcf[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bin,bn->bi", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h
