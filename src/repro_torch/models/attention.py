"""Attention mixers: full / sliding-window GQA with QKV bias and a KV cache
(a ring of ``window`` slots for SWA), cross-attention, and MLA.

Port of ``repro.models.attention``. Where the JAX package computes attention
in jnp (``blocked_attention`` for train and prefill, ``_cached_attention``
for decode), the port calls the kernels of the ``kernels`` dict it is handed
(default ``repro_torch.kernels.ops.kernel_set()``): ``flash_attention`` for
the no-cache and prefill branches and for cross-attention over the encoder
memory, ``flash_decode`` for decode, over a ring by its slots' positions and
over the memory with every slot visible. Where a gradient is needed
(training), the no-cache branch goes through ``FlashAttention``, a
``torch.autograd.Function`` that pairs the forward kernel (with its
log-sum-exp) and ``flash_attention_bwd`` (K1); under ``inference_mode`` it
calls the forward alone.

MLA (minicpm3) keeps the reference's three branches: without a cache and in
prefill it rebuilds per-head K (nope ‖ shared rope, Dk 96) and V (Dv 64)
and calls ``flash_attention`` at that pair; its decode is the reference's
absorbed attention over the latent cache, plain matmuls (the JAX package has
no kernel there either).

Under axis rules that put ``heads`` over a ``model`` axis of tp > 1
(``common.tensor_parallel``), training attention is Megatron's: the
projections are column-parallel over this rank's H/tp heads (the input
enters through ``to_model``), attention runs on the local heads, and ``wo``
is row-parallel, its partial output summed by one all-reduce
(``from_model``). Where ``kv_heads`` stays replicated (KVH not a multiple of
tp), each rank projects every KV head with the weights entering through
``to_model`` (their gradient is partial) and keeps those its query heads
read (``_local_kv``). MLA keeps its latents replicated and splits the heads.

Serving on a mesh (``dist.step.make_serve_fns``): each rank's cache holds its
shard of the serve rules' placement, and one path (``_cached_attention``)
serves it and a one-device cache alike (the latter is one slice, r = 0 of
n = 1, nothing gathered or merged). Where ``kv_heads`` is sharded, a rank's
cache holds its KV heads, prefill and decode run the kernels on the local
heads, and ``wo`` is row-parallel, as in training. Where the cache's slots
are split (``kv_seq``: KV heads that do not divide the model axis, or a batch
that does not fill the data axes; the cache's ``split`` entry holds this
rank's index along the split and its mesh axes), each rank keeps the slots
``[r S/n, (r+1) S/n)`` of every KV head: prefill attends over the prompt's
own K/V (slots past the prompt are causally dead in a fresh cache) and writes
its own slots; decode writes the new slot on the rank that owns it, runs
``flash_decode(..., return_lse=True)`` for every query head over its slice
(its local written count ``clamp(total - r S/n, 0, S/n)``, the slots' global
positions; the query heads gathered over ``model`` first where the heads are
local shards) and merges the ranks' partials by their log-sum-exp
(``dist.comm.merge_attention``), each in f32, rounded once. A ring's slot
``idx % S`` belongs to the rank that holds it; its ``pos`` is split with it.
MLA's absorbed decode computes the same partial (max, sum of exponentials)
over its slice of the latents and merges it the same way.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ops import kernel_set

from .common import NEG_INF, ArchConfig, ParamBuilder, apply_rope, parallel, rms_norm, tensor_parallel


def heads_parallel():
    """The tensor-parallel view when attention heads are local shards."""
    par = tensor_parallel()
    return par if par is not None and par.sharded("heads") else None


def _kv_weights(p: dict, par, names=("wk", "wv", "bk", "bv")) -> dict:
    """K/V weights for the local heads' use: replicated ones (KVH over no
    axis) enter through ``to_model``, since each rank's gradient is partial."""
    if par is None or par.sharded("kv_heads"):
        return {n: p[n] for n in names if n in p}
    return {n: par.to_model(p[n]) for n in names if n in p}


def _local_kv(par, k: torch.Tensor, v: torch.Tensor, h_loc: int):
    """From replicated K/V (B, S, KVH, Dh), the KV head of each of this
    rank's query heads (h // (H / KVH)): the local heads then hold one KV
    head each (KVH not a multiple of tp means they never hold whole GQA
    groups)."""
    if par is None or par.sharded("kv_heads"):
        return k, v
    g, h0 = h_loc * par.tp // k.shape[2], par.tp_rank * h_loc
    idx = torch.arange(h0, h0 + h_loc, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def init_attention(pb: ParamBuilder, cfg: ArchConfig) -> dict:
    d, H, KVH, Dh = cfg.d_model, cfg.n_heads_eff, cfg.n_kv_heads, cfg.head_dim
    if H % KVH:
        raise ValueError(f"padded heads {H} must stay a multiple of kv={KVH}")
    # Scaled by the true fan-in (d for wq/wk/wv, H*Dh for wo). The reference's
    # ParamBuilder.dense takes shape[-2] (H, KVH, Dh) for these 3-D weights,
    # which gives attention logits of std ~64 at init: a random model whose
    # full depth amplifies any rounding difference until its outputs decorrelate.
    p = {
        "wq": pb.dense((d, H, Dh), ("embed", "heads", "head_dim"), scale=d**-0.5),
        "wk": pb.dense((d, KVH, Dh), ("embed", "kv_heads", "head_dim"), scale=d**-0.5),
        "wv": pb.dense((d, KVH, Dh), ("embed", "kv_heads", "head_dim"), scale=d**-0.5),
        "wo": pb.dense((H, Dh, d), ("heads", "head_dim", "embed"), scale=(H * Dh) ** -0.5),
    }
    if cfg.pad_heads:
        p["wo"][cfg.n_heads:] = 0
    if cfg.qkv_bias:
        p["bq"] = pb.zeros((H, Dh), ("heads", "head_dim"))
        p["bk"] = pb.zeros((KVH, Dh), ("kv_heads", "head_dim"))
        p["bv"] = pb.zeros((KVH, Dh), ("kv_heads", "head_dim"))
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bld,dhk->blhk') as one matmul."""
    B, L, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, L, *w.shape[1:])


def _project_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, par=None):
    kv = _kv_weights(p, par)
    if par is not None:
        x = par.to_model(x)
    q, k, v = _proj(x, p["wq"]), _proj(x, kv["wk"]), _proj(x, kv["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + kv["bk"]
        v = v + kv["bv"]
    # RoPE on q/k: every head of a token rotates by that token's position
    q = apply_rope(q, positions[:, :, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, :, None], cfg.rope_theta)
    return q, k, v  # k, v: the KV heads this rank holds (all where kv_heads is replicated)


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
    cross_kv: Optional[tuple] = None,  # (k, v) (B, T, KVH, Dh): the encoder memory's
    kernels: Optional[dict] = None,
):
    """Self-attention with optional KV cache, or cross-attention over
    ``cross_kv`` — returns (y, new_cache).

    The cache's K/V (and a ring's positions) are written in place (the JAX
    step donates its buffers instead); ``new_cache`` holds the same tensors
    and the advanced index, a host ``int``, so decode never waits on the
    device for it. Cross-attention (reference ``:221-230``) projects q with
    no bias and no RoPE and attends to every memory slot; ``cache`` passes
    through."""
    kernels = kernels or kernel_set()
    B, L, _ = x.shape
    par = heads_parallel()
    if cross_kv is not None:
        q = _proj(x if par is None else par.to_model(x), p["wq"])
        mk, mv = _local_kv(par, *cross_kv, q.shape[2])
        if L > 1:
            out = attention(q, mk, mv, causal=False, window=0, kernels=kernels)
        else:  # one query: every memory slot is visible (k_pos = q_pos = 0)
            T, i32 = mk.shape[1], dict(dtype=torch.int32, device=x.device)
            out = kernels["flash_decode"](q, mk, mv, torch.zeros((B, T), **i32), torch.zeros((B,), **i32),
                                          torch.full((B,), T, **i32))
        return _out_proj(p, out, par), cache

    q, k, v = _project_qkv(p, cfg, x, positions, par)
    window = cfg.window if cfg.attention == "swa" else 0

    if cache is None:
        k, v = _local_kv(par, k, v, q.shape[2])
        out = attention(q, k, v, causal=True, window=window, kernels=kernels)
        return _out_proj(p, out, par), None
    return _cached_attention(p, q, k, v, positions, cache, par, window, kernels)


def _split_of(cache: dict):
    """(r, axes, n, merge): this rank's index along the split of the cache's
    slots, the split's mesh axes, their rank count, and the merge of this
    rank's partial attention (out, lse) with the others'; (0, (), 1, None)
    for slots that are not split."""
    if "split" not in cache:
        return 0, (), 1, None
    from repro_torch.dist.comm import merge_attention

    r, axes = cache["split"]
    comm = parallel().comm
    return r, axes, comm.size(axes), lambda out, lse: merge_attention(out, lse, comm, axes)


def _cached_attention(p, q, k, v, positions, cache: dict, par, window: int, kernels: dict):
    """Self-attention against a cache (reference ``:232-306``): a cache of
    its own slots (n = 1), or a shard of one placed on a mesh, whose KV heads
    may be replicated over ``model`` or whose slots may be split (module
    docstring). q holds this rank's query heads; k, v (B, L, KVH, Dh) every
    KV head this rank's cache holds. Prefill starts at index 0 with L <= S
    (``prefill_refusal``)."""
    B, L = q.shape[:2]
    ck, cv, kpos = cache["k"], cache["v"], cache.get("pos")
    S_loc = ck.shape[1]
    r, _, n, merge = _split_of(cache)
    base, S, idx = r * S_loc, n * S_loc, cache["index"]
    if L > 1:
        if idx != 0:
            raise ValueError(f"prefill must start from an empty cache, not index {idx}")
        refused = prefill_refusal(L, S, ring=kpos is not None)
        if refused:
            raise ValueError(refused)
        hi = min(base + S_loc, L)  # this rank's slots that the prompt fills
        if hi > base:
            ck[:, : hi - base] = k[:, base:hi]
            cv[:, : hi - base] = v[:, base:hi]
            if kpos is not None:
                kpos[:, : hi - base] = positions[:, base:hi]
        # over the whole cache where this rank holds it (slots >= L are
        # causally dead in a fresh cache), else over the prompt's own K/V
        kq, vq = (ck, cv) if n == 1 and kpos is None else (k, v)
        kq, vq = _local_kv(par, kq, vq, q.shape[2])
        out = kernels["flash_attention"](q, kq, vq, causal=True, window=window)
    else:
        refused = None if kpos is not None else decode_refusal(idx, S)
        if refused:
            raise ValueError(refused)
        i32 = dict(dtype=torch.int32, device=q.device)
        if n == 1 and kpos is None:
            # a plain cache of its own slots: the slot written and the count
            # follow from the step's position on the device (= idx), so that
            # a CUDA graph captured once replays every step
            slot = positions[:1, 0].long()
            ck.index_copy_(1, slot, k)
            cv.index_copy_(1, slot, v)
            n_valid = (positions[:, 0] + 1).to(torch.int32)
        else:
            slot = idx % S if kpos is not None else idx
            written = min(idx + 1, S)  # slots written after this step, from slot 0 on
            if base <= slot < base + S_loc:
                ck[:, slot - base] = k[:, 0]
                cv[:, slot - base] = v[:, 0]
                if kpos is not None:
                    kpos[:, slot - base] = positions[:, 0]
            n_valid = torch.full((B,), max(0, min(written - base, S_loc)), **i32)
        k_pos = kpos if kpos is not None else (base + torch.arange(S_loc, **i32)).expand(B, S_loc).contiguous()
        gathered = par is not None and not par.sharded("kv_heads")  # every query head attends here
        qd = par.comm.all_gather(q, 2, ("model",)) if gathered else q
        args = (qd, ck, cv, k_pos, positions[:, 0].to(torch.int32), n_valid)
        if merge is None:
            o = kernels["flash_decode"](*args, window=window)
        else:  # this slice's f32 partial, merged over the split by its log-sum-exp: rounded once
            o = merge(*kernels["flash_decode"](*args, window=window, return_lse=True, out_dtype=torch.float32))
        if gathered:
            h = q.shape[2]
            o = o[:, :, par.tp_rank * h : (par.tp_rank + 1) * h]
        out = o.to(q.dtype)
    new_cache = {"k": ck, "v": cv, "index": idx + L}
    if kpos is not None:
        new_cache["pos"] = kpos
    if "split" in cache:
        new_cache["split"] = cache["split"]
    return _out_proj(p, out, par), new_cache


def _out_proj(p: dict, out: torch.Tensor, par=None) -> torch.Tensor:
    """einsum('blhk,hkd->bld', out, wo) as one matmul; over local heads, the
    partial sums all-reduced over ``model``."""
    B, L, H, Dv = out.shape
    y = out.reshape(B, L, H * Dv) @ p["wo"].reshape(H * Dv, -1)
    return y if par is None else par.from_model(y)


def memory_kv(p: dict, memory: torch.Tensor) -> tuple:
    """The encoder memory's cross-attention K and V (B, T, KVH, Dh): no bias,
    no RoPE (reference ``transformer.py:102-103``); every KV head, or the
    local ones where ``kv_heads`` is sharded."""
    par = heads_parallel()
    kv = _kv_weights(p, par, ("wk", "wv"))
    if par is not None:
        memory = par.to_model(memory)
    return _proj(memory, kv["wk"]), _proj(memory, kv["wv"])


def cache_slots(cfg: ArchConfig, max_len: int) -> int:
    """Slots of an attention layer's cache: a SWA config's window at most."""
    return min(max_len, cfg.window) if (cfg.attention == "swa" and cfg.window) else max_len


def is_ring(cfg: ArchConfig, max_len: int) -> bool:
    """Whether an attention layer's cache of ``max_len`` is a ring: a SWA
    config's, whose slots reach its window."""
    return bool(cfg.attention == "swa" and cfg.window and cache_slots(cfg, max_len) == cfg.window)


def prefill_refusal(n_tokens: int, slots: int, ring: bool) -> Optional[str]:
    """Why ``_cached_attention`` refuses a prefill of ``n_tokens`` into a
    fresh cache of ``slots``, or None: a prompt longer than the cache (into a
    ring, the reference's scatter writes repeated slots in one update, in no
    defined order, and has no answer to match)."""
    if n_tokens > slots:
        return f"prefill of {n_tokens} tokens into {'a ring of ' if ring else ''}{slots} slots"
    return None


def decode_refusal(index: int, slots: int) -> Optional[str]:
    """Why a decode step at ``index`` into a plain cache of ``slots`` is
    refused, or None: a full cache (a ring never fills)."""
    if index + 1 > slots:
        return f"KV cache full: {index} + 1 tokens > {slots} slots"
    return None


def init_attention_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> dict:
    """K/V (B, S, KVH, Dh) zeros and index 0; a SWA config whose S reaches
    its window is a ring, with each slot's position (B, S) int32, -1 until
    written (reference ``:307-316``)."""
    S = cache_slots(cfg, max_len)
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }
    if is_ring(cfg, max_len):
        cache["pos"] = torch.full((batch, S), -1, dtype=torch.int32, device=device)
    return cache


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------


def init_mla(pb: ParamBuilder, cfg: ArchConfig) -> dict:
    d, H = cfg.d_model, cfg.n_heads_eff
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    # the 3-D weights scaled by their true fan-in, as in init_attention
    p = {
        "wq_a": pb.dense((d, qr), ("embed", "q_lora")),
        "q_norm": pb.ones((qr,), ("q_lora",)),
        "wq_b": pb.dense((qr, H, dn + dr), ("q_lora", "heads", "head_dim"), scale=qr**-0.5),
        "wkv_a": pb.dense((d, kvr + dr), ("embed", "kv_lora")),
        "kv_norm": pb.ones((kvr,), ("kv_lora",)),
        "wk_b": pb.dense((kvr, H, dn), ("kv_lora", "heads", "head_dim"), scale=kvr**-0.5),
        "wv_b": pb.dense((kvr, H, dv), ("kv_lora", "heads", "head_dim"), scale=kvr**-0.5),
        "wo": pb.dense((H, dv, d), ("heads", "head_dim", "embed"), scale=(H * dv) ** -0.5),
    }
    if cfg.pad_heads:
        p["wo"][cfg.n_heads:] = 0
    return p


def _mla_kv(p: dict, cfg: ArchConfig, c_kv: torch.Tensor, k_rope: torch.Tensor):
    """Per-head K (B, S, H, nope + rope) and V (B, S, H, v) from the latents
    c_kv (B, S, kvr) and the shared rotary key k_rope (B, S, rope)."""
    B, S, _ = c_kv.shape
    H = p["wk_b"].shape[1]  # the local heads under tensor parallelism
    k_nope = _proj(c_kv, p["wk_b"])
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, cfg.qk_rope_dim)], dim=-1)
    return k, _proj(c_kv, p["wv_b"])


def mla_block(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, L, D)
    positions: torch.Tensor,  # (B, L)
    cache: Optional[dict] = None,  # see init_mla_cache
    kernels: Optional[dict] = None,
):
    """MLA (reference ``:350-432``) — returns (y, new_cache). The latent
    cache is written in place; its index is a host ``int``."""
    kernels = kernels or kernel_set()
    B, L, _ = x.shape
    par = heads_parallel()
    to_heads = (lambda t: t) if par is None else par.to_model  # replicated latents -> local heads
    dn, kvr = cfg.qk_nope_dim, cfg.kv_lora_rank
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = _proj(to_heads(cq), p["wq_b"])  # (B, L, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions[:, :, None], cfg.rope_theta)
    ckv_full = x @ p["wkv_a"]  # (B, L, kvr + dr)
    c_kv = rms_norm(ckv_full[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., kvr:], positions, cfg.rope_theta)  # (B, L, dr), shared by the heads

    if cache is None:
        k, v = _mla_kv(p, cfg, to_heads(c_kv), to_heads(k_rope))
        out = attention(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=True, window=0, kernels=kernels)
        return _out_proj(p, out, par), None

    idx = cache["index"]
    c_all, r_all = cache["c_kv"], cache["k_rope"]
    S_loc = c_all.shape[1]
    r, axes, n, merge = _split_of(cache)
    base = r * S_loc
    if idx + L > n * S_loc:
        raise ValueError(f"latent cache full: {idx} + {L} tokens > {n * S_loc} slots")
    lo, hi = max(idx, base), min(idx + L, base + S_loc)  # this rank's slots of the new tokens
    if hi > lo:
        c_all[:, lo - base : hi - base] = c_kv[:, lo - idx : hi - idx]
        r_all[:, lo - base : hi - base] = k_rope[:, lo - idx : hi - idx]
    total = idx + L
    new_cache = {"c_kv": c_all, "k_rope": r_all, "index": total}
    if "split" in cache:
        new_cache["split"] = cache["split"]

    if L > 1:
        # prefill: per-head K/V rebuilt from every latent slot, causal over
        # them (slots >= L are causally dead for a fresh cache); a rank that
        # holds a slice of the slots rebuilds them from the prompt's own latents
        if idx != 0:
            raise ValueError(f"prefill must start from an empty cache, not index {idx}")
        k, v = _mla_kv(p, cfg, c_kv, k_rope) if merge is not None else _mla_kv(p, cfg, c_all, r_all)
        out = kernels["flash_attention"](torch.cat([q_nope, q_rope], dim=-1), k, v, causal=True, window=0)
        return _out_proj(p, out, par), new_cache

    # decode: absorbed attention over the latent cache, in f32 as the
    # reference's preferred_element_type: q_nope^T (W_kb c) = (q_nope W_kb)^T c
    q_lat = torch.einsum("blhk,rhk->blhr", q_nope, p["wk_b"])  # (B, L, H, kvr)
    gathered = par is not None and "model" in axes  # every head attends to this rank's slice
    if gathered:
        q_lat, q_rope = (par.comm.all_gather(t, 2, ("model",)) for t in (q_lat, q_rope))
    s = (torch.einsum("blhr,bsr->bhls", q_lat.float(), c_all.float())
         + torch.einsum("blhk,bsk->bhls", q_rope.float(), r_all.float())) * (dn + cfg.qk_rope_dim) ** -0.5
    slot = base + torch.arange(S_loc, device=x.device)
    ok = (slot[None, None, :] <= positions[:, :, None]) & (slot < total)[None, None, :]  # (B, L, S)
    s = torch.where(ok[:, None], s, torch.full((), NEG_INF, device=x.device))
    if merge is None:
        pw = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhls,bsr->blhr", pw, c_all.float())
    else:  # this slice's partial softmax, merged over the split by its log-sum-exp
        m = s.amax(-1, keepdim=True)
        pw = torch.exp(s - m)
        l_sum = pw.sum(-1)  # (B, H, L)
        live = ok.any(-1)[:, None]  # (B, 1, L)
        o_lat = torch.einsum("bhls,bsr->blhr", pw, c_all.float()) / l_sum.transpose(1, 2)[..., None]
        o_lat = torch.where(live.transpose(1, 2)[..., None], o_lat, torch.zeros((), device=x.device))
        lse = torch.where(live, m[..., 0] + torch.log(l_sum), torch.full((), NEG_INF, device=x.device))
        o_lat = merge(o_lat, lse[:, :, 0])
    if gathered:
        h = p["wk_b"].shape[1]
        o_lat = o_lat[:, :, par.tp_rank * h : (par.tp_rank + 1) * h]
    o = torch.einsum("blhr,rhk->blhk", o_lat.to(x.dtype), p["wv_b"])  # (B, L, H, dv)
    return _out_proj(p, o, par), new_cache


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
        "index": 0,
    }
