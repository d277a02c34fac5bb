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

Group-local dispatch (``moe_groups = G > 1``, the reference's ``:98-143``)
splits the tokens into G groups, each sorted and binned with
``expert_capacity(T // G)`` (``T % G != 0`` falls back to G = 1); where the
reference runs einsums for G > 1, the port runs ``moe_gmm`` (and K7a) once
per group.

On a mesh (``common.parallel``), the dispatch stays the global one the
reference computes. The batch ranks each hold T/dp consecutive tokens; they
all-gather their per-(group, expert) slot counts, a rank's slot in a bin
starts after the earlier ranks' counts, and a token is kept iff that slot
is below C(T_global / G), so the drops are the one-device step's. A rank
bins only its own kept tokens (C_loc = min(C, Tg, T) rows a bin; SwiGLU is
row-wise), and the aux loss's means are sums over the batch ranks. Where the
rules shard ``experts`` over ``model`` (expert parallelism), a rank runs its
E/tp bins; where they shard ``mlp`` instead, every expert's F/tp columns.
Either way the dispatch source and the gate weights enter through
``to_model`` and the combine is all-reduced over ``model``; the router is
stored over ``experts`` as the rules say and gathered whole for routing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import kernel_set
from repro_torch.obs import span

from .common import ArchConfig, ParamBuilder, parallel


def init_moe(pb: ParamBuilder, cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": pb.dense((d, e), ("embed", "experts"), scale=d**-0.5),
        "w_gate": pb.dense((e, d, f), ("experts", "embed", "mlp")),
        "w_up": pb.dense((e, d, f), ("experts", "embed", "mlp")),
        "w_down": pb.dense((e, f, d), ("experts", "mlp", "embed")),
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


def bin_counts(key: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(key, minlength=n)`` for keys in [0, n), as a
    static-shape op: bincount's output size depends on the data (no meta
    kernel; a host sync on a card)."""
    return torch.zeros((n,), dtype=torch.int64, device=key.device).index_add_(0, key, torch.ones_like(key))


def _dispatch(xf: torch.Tensor, gate_e: torch.Tensor, K: int, E: int, C: int, G: int, par=None,
              experts: tuple = (0, None)):
    """Group-local sort-based dispatch of this rank's tokens.

    xf (T, D) and gate_e (T, K) are the T tokens of batch rank r of dp (T*r
    onwards in the global order), in groups of Tg = dp*T // G global tokens.
    Returns (xe (Gl, El, Cl, D), slot_by_flat (T*K,), kept): the bins of the
    Gl groups this rank's tokens fall in and of experts ``[e0, e1)``, each
    token-slot's row in ``xe`` viewed as (Gl*El*Cl, D) (the dump row
    Gl*El*Cl where it was dropped or belongs to another rank's experts), and
    the number of token-slots kept over all batch ranks. Slots are ordered by
    a stable sort of (group, expert) over the flattened (t, k), as the
    reference's per-group sort; a slot is kept iff its place in its bin,
    after the earlier ranks' slots, is below C."""
    T, D = xf.shape
    dp, r = (1, 0) if par is None else (par.dp, par.dp_rank)
    Tg = dp * T // G
    g_lo, g_hi = (r * T) // Tg, (r * T + T - 1) // Tg
    Gl = g_hi - g_lo + 1
    e0, e1 = experts[0], experts[1] if experts[1] is not None else E
    El = e1 - e0
    Cl = C if dp == 1 else min(C, Tg, T)
    dev = xf.device
    group = (torch.arange(r * T, r * T + T, device=dev) // Tg - g_lo).repeat_interleave(K)  # (T*K,)
    key = group * E + gate_e.reshape(-1)
    sort_idx = torch.argsort(key, stable=True)
    sorted_key = key[sort_idx]
    counts = bin_counts(key, Gl * E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - starts[sorted_key]  # place among this rank's slots in the bin
    if dp > 1:
        every = torch.zeros((G * E,), dtype=counts.dtype, device=dev)
        every[g_lo * E : (g_hi + 1) * E] = counts
        every = par.batch_gather(every)  # (dp, G*E)
        before = every[:r].sum(0)[g_lo * E : (g_hi + 1) * E]
        keep = before[sorted_key] + pos < C
        kept = torch.minimum(every.sum(0), torch.full((), C, device=dev)).sum()
    else:
        keep = pos < C
        kept = keep.sum()
    g, e = sorted_key // E, sorted_key % E
    mine = keep & (e >= e0) & (e < e1)
    dump = Gl * El * Cl
    dest = torch.where(mine, (g * El + e - e0) * Cl + pos, dump)
    xbuf = torch.zeros((dump + 1, D), dtype=xf.dtype, device=dev)
    xbuf[dest] = xf[sort_idx // K]  # kept slots are distinct; the dump row is discarded
    slot_by_flat = torch.empty_like(dest)
    slot_by_flat[sort_idx] = dest
    return xbuf[:dump].view(Gl, El, Cl, D), slot_by_flat, kept


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
    """Returns (y (B, L, D), {"aux_loss", "dropped_frac"}), both f32 scalars,
    of the whole batch on a mesh."""
    kernels = kernels or kernel_set()
    par = parallel()
    dp = 1 if par is None else par.dp
    tp = par if par is not None and par.tp > 1 and (par.sharded("experts") or par.sharded("mlp")) else None
    B, L, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * L
    T_all = T * dp
    G = max(1, cfg.moe_groups)
    if T_all % G:
        G = 1
    C = expert_capacity(T_all // G, cfg)
    xf = x.reshape(T, D)

    with span("moe.route"):
        router = p["router"]
        if par is not None and par.tp > 1 and router.shape[1] != E:  # stored over experts
            from repro_torch.dist.comm import gather

            router = gather(router, par.comm, 1, ("model",), grads="same")
        probs, gate_w, gate_e = route({"router": router}, cfg, xf)
        # Switch aux loss: E * sum_e (top-1 token fraction_e * mean prob_e)
        onehot = F.one_hot(gate_e[:, 0], E).float()
        if dp > 1:
            prob_mean = par.batch_sum(probs.sum(0)) / T_all
            frac = par.comm.all_reduce(onehot.sum(0), par.batch) / T_all
            aux_loss = E * torch.mean(prob_mean * frac)
        else:
            aux_loss = E * torch.mean(probs.mean(0) * onehot.mean(0))

    with span("moe.dispatch"):
        experts = (0, None)
        if tp is not None:
            xf, gate_w = tp.to_model(xf), tp.to_model(gate_w)
            if tp.sharded("experts"):
                e_loc = p["w_gate"].shape[0]
                experts = (tp.tp_rank * e_loc, (tp.tp_rank + 1) * e_loc)
        xe, slot_by_flat, kept = _dispatch(xf, gate_e, K, E, C, G, par, experts)
    with span("moe.experts"):
        hs = [grouped_swiglu(xg, p["w_gate"], p["w_up"], p["w_down"], kernels) for xg in xe]  # one launch a group
        h = hs[0] if len(hs) == 1 else torch.stack(hs)

    with span("moe.combine"):
        ybuf = torch.cat([h.reshape(-1, D), h.new_zeros((1, D))])
        y = ybuf[slot_by_flat].view(T, K, D)
        y = (y * gate_w[..., None].to(y.dtype)).sum(dim=1)
        if tp is not None:
            y = tp.from_model(y)
        y = y.view(B, L, D).to(x.dtype)
    dropped = T_all * K - kept
    return y, {
        "aux_loss": aux_loss,
        "dropped_frac": dropped.float() / (T_all * K),
    }


def init_dense_ffn(pb: ParamBuilder, cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": pb.dense((d, f), ("embed", "mlp")),
        "w_up": pb.dense((d, f), ("embed", "mlp")),
        "w_down": pb.dense((f, d), ("mlp", "embed")),
    }


def dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; column-parallel ``w_gate`` / ``w_up`` and row-parallel
    ``w_down`` with one all-reduce where the rules shard ``mlp``."""
    par = parallel()
    tp = par if par is not None and par.tp > 1 and par.sharded("mlp") else None
    if tp is not None:
        x = tp.to_model(x)
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    y = (F.silu(g) * u) @ p["w_down"]
    return y if tp is None else tp.from_model(y)
