"""Plain PyTorch oracles for the port's kernels (port of ``repro.kernels.ref``).

Deliberately naive: full score matrices in f32, dense per-expert products,
a direct sequential scan over time, the tree hash widened to int64. The kernel wrappers use them
for tensors on the CPU (the tests) and on the meta device (ghost runs); on a card they are what ``chip_smoke.py``
holds each kernel against. Nothing on the serving or training path calls
them when the tensors lie on a card.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import NEG_INF


# Devices whose tensors the kernel wrappers hand to these plain versions: the
# host, and the meta device of ghost runs (shapes only, no bytes, no launch).
PLAIN_DEVICES = ("cpu", "meta")


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the oracles compute in: f32, or f64 for f64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _gqa_scores(qg, k, ok):
    """Scaled, masked scores (B, KVH, gq, Lq, Lk) of qg (B, Lq, KVH, gq, Dh)
    against k (B, Lk, KVH, Dh); ok broadcastable to the scores."""
    acc = _acc(qg.dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(acc), k.to(acc)) * (qg.shape[-1] ** -0.5)
    return torch.where(ok, s, torch.full((), NEG_INF, dtype=acc, device=s.device))


def _gqa_softmax_v(qg, k, v, ok, out_shape, dtype):
    """qg (B, Lq, KVH, gq, Dk); k (B, Lk, KVH, Dk), v (B, Lk, KVH, Dv); ok
    broadcastable to (B, KVH, gq, Lq, Lk)."""
    p = torch.softmax(_gqa_scores(qg, k, ok), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(p.dtype))
    return o.reshape(out_shape).to(dtype)


def _attention_mask(Lq: int, Lk: int, causal: bool, window: int, device) -> torch.Tensor:
    q_pos = torch.arange(Lq, device=device)[:, None]
    k_pos = torch.arange(Lk, device=device)[None, :]
    ok = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    return ok


def reference_attention(
    q: torch.Tensor,  # (B, Lq, H, Dk)
    k: torch.Tensor,  # (B, Lk, KVH, Dk)
    v: torch.Tensor,  # (B, Lk, KVH, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    return_lse: bool = False,
):
    """softmax(q k^T / sqrt(Dk) + mask) v, (B, Lq, H, Dv) in q's dtype; with
    ``return_lse`` also each row's log-sum-exp of its scaled, masked scores
    (B, H, Lq), in f32 (f64 for f64 inputs)."""
    B, Lq, H, Dk = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Lq, KVH, H // KVH, Dk)
    ok = _attention_mask(Lq, Lk, causal, window, q.device)
    out_shape = (B, Lq, H, v.shape[-1])
    if not return_lse:
        return _gqa_softmax_v(qg, k, v, ok, out_shape, q.dtype)
    s = _gqa_scores(qg, k, ok)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v.to(s.dtype))
    return o.reshape(out_shape).to(q.dtype), torch.logsumexp(s, dim=-1).reshape(B, H, Lq)


def reference_attention_bwd(
    q: torch.Tensor,  # (B, Lq, H, Dh)
    k: torch.Tensor,  # (B, Lk, KVH, Dh)
    v: torch.Tensor,  # (B, Lk, KVH, Dh)
    o: torch.Tensor,  # (B, Lq, H, Dh) the forward's output
    do: torch.Tensor,  # (B, Lq, H, Dh) its cotangent
    lse: torch.Tensor,  # (B, H, Lq) the forward's log-sum-exp
    *,
    causal: bool = True,
    window: int = 0,
):
    """Plain oracle for ``flash_attention_bwd``: (dq, dk, dv) in the inputs'
    dtypes, computed in f32 (f64 for f64 inputs) from the full score matrix.
    P = exp(S * scale - lse) is recomputed from lse; dV = P^T dO;
    dS = P * (dO V^T - rowsum(dO * O)); dQ = dS K * scale and dK = dS^T Q *
    scale. dK and dV sum over each KV head's gq query heads."""
    B, Lq, H, Dh = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    gq = H // KVH
    acc = _acc(q.dtype)
    qg = q.reshape(B, Lq, KVH, gq, Dh)
    dog = do.reshape(B, Lq, KVH, gq, Dh).to(acc)
    s = _gqa_scores(qg, k, _attention_mask(Lq, Lk, causal, window, q.device))
    p = torch.exp(s - lse.to(acc).reshape(B, KVH, gq, Lq)[..., None])  # masked: exp(NEG_INF - lse) = 0
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.to(acc))
    dsum = (do.to(acc) * o.to(acc)).sum(-1).reshape(B, Lq, KVH, gq).permute(0, 2, 3, 1)  # (B, KVH, gq, Lq)
    ds = p * (dp - dsum[..., None])
    scale = Dh**-0.5
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.to(acc)) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg.to(acc)) * scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def split_decode_reference(
    q: torch.Tensor,  # (B, 1, H, Dh)
    k: torch.Tensor,  # (B, S, KVH, Dh)
    v: torch.Tensor,  # (B, S, KVH, Dh)
    k_pos: torch.Tensor,  # (B, S)
    q_pos: torch.Tensor,  # (B,)
    n_valid: torch.Tensor,  # (B,)
    *,
    window: int = 0,
    n_split: int = 1,
) -> torch.Tensor:
    """Plain model of ``flash_decode``'s split and merge, for the tests: the
    n = min(n_valid, S) written slots of a batch row are cut into ``n_split``
    contiguous chunks of ceil(n / n_split) slots. Each chunk's softmax state
    stands alone: m its max score (NEG_INF where every slot is masked, and for
    an empty chunk), l = sum exp(s - m) and acc = sum p v with p rounded to v's
    dtype (l = 0, acc = 0 for an empty chunk). The states merge with weights
    exp(m_j - M), M the largest m_j, with no special case."""
    B, _, H, Dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, KVH, H // KVH, Dh).float()
    out = torch.empty(qg.shape, dtype=torch.float32, device=q.device)
    for b in range(B):
        n = max(0, min(int(n_valid[b]), S))
        chunk = -(-n // n_split)
        ms, ls, accs = [], [], []
        for j in range(n_split):
            lo = min(n, j * chunk)
            hi = min(n, lo + chunk)
            s = torch.einsum("hgd,chd->hgc", qg[b], k[b, lo:hi].float()) * Dh**-0.5
            pos = k_pos[b, lo:hi]
            ok = pos <= q_pos[b]
            if window > 0:
                ok &= pos > q_pos[b] - window
            s = torch.where(ok, s, torch.full((), NEG_INF, device=s.device))
            m = s.amax(-1) if hi > lo else torch.full(qg.shape[1:3], NEG_INF, device=s.device)
            p = torch.exp(s - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("hgc,chd->hgd", p.to(v.dtype).float(), v[b, lo:hi].float()))
        m = torch.stack(ms)  # (n_split, KVH, gq)
        w = torch.exp(m - m.amax(0))
        L = (w * torch.stack(ls)).sum(0)
        A = (w[..., None] * torch.stack(accs)).sum(0)
        out[b] = A / L.clamp_min(1e-37)[..., None]
    return out.reshape(q.shape).to(q.dtype)


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


def reference_hash_tree_bytes(u8: torch.Tensor, *, block_words: int = 128) -> torch.Tensor:
    """Plain oracle for ``hash_tree.hash_tree_states``: the tree state of a 1-D
    uint8 payload of any length, as a (3,) int32 tensor of uint32 bits. The
    bytes are read as little-endian uint32 words; a partial last block and a
    0..3-byte tail (packed little-endian into one more word) form one more
    block, which zero bytes pad to a whole one without changing its sum. Then
    ``reference_hash_tree`` over the words, in its int64 arithmetic."""
    if u8.dim() != 1 or u8.dtype != torch.uint8:
        raise TypeError(f"want 1-D uint8 bytes, got {u8.dtype} {tuple(u8.shape)}")
    pad = -u8.numel() % (4 * block_words)
    b = torch.cat([u8, u8.new_zeros(pad)]).to(torch.int64).reshape(-1, 4)
    words = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return reference_hash_tree(words, block_words=block_words)


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
