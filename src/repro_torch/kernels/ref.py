"""Plain PyTorch oracles for the port's kernels (port of ``repro.kernels.ref``).

Deliberately naive: full score matrices in f32, dense per-expert products,
a direct sequential scan over time, the tree hash widened to int64. The kernel wrappers use them
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


_U32 = 0xFFFFFFFF


def _mul_u32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 tensors (or ``b`` an int) holding uint32 values, without
    forming a product of 2**63 or more: ``b`` is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor of the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def reference_hash_tree(words: torch.Tensor, *, block_words: int = 128) -> torch.Tensor:
    """Plain oracle for ``hash_tree.hash_tree_state``: the blockwise tree state
    (sum of mixed, xor of mixed, sum of block sums) mod 2**32, as a (3,) int32
    tensor of uint32 bits. ``words`` is int32 (or any integer type) holding
    uint32 bits; ``len(words)`` must be a multiple of ``block_words``.

    Exact in int64 torch arithmetic: every sum is masked to 32 bits, products
    go through ``_mul_u32``, and the XOR reduction (no PyTorch call reduces by
    XOR) is pairwise folding, halving the vector per pass."""
    w = words.reshape(-1, block_words).to(torch.int64) & _U32
    s = w.sum(dim=1) & _U32
    j = torch.arange(s.numel(), dtype=torch.int64, device=w.device) & _U32
    c = ((_mul_u32(j, 0x9E3779B1) + 0x85EBCA77) & _U32) | 1
    m = _mul_u32(s ^ c, c)
    x = m
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[0::2] ^ x[1::2]
    h2 = x.sum()  # the one element left, or 0 for no blocks
    return _as_i32_bits(torch.stack([m.sum() & _U32, h2, s.sum() & _U32]))


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
