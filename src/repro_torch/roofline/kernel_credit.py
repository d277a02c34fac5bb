"""Kernel-credit substitution for the memory roofline term.

Port of ``repro.roofline.kernel_credit``, copied onto the port's
``ArchConfig`` and ``expert_capacity``: the formula and ``cfg.block_q`` stay
the reference's, so the credit equals the reference's; layers are counted
over ``cfg.layer_specs()`` (the layout times its groups for a whole config,
the layers it holds for one cut in depth). The dry-run counts a
ghost run on meta tensors, where each kernel wrapper computes its plain
version (``kernels/ref.py``: whole score matrices, dense per-expert
products, a step-by-step scan) — on the card those regions run as the
hand-written CUDA kernels, whose tiles stay on chip. The counter
(``op_costs``) attributes every region's traffic to its ``pallas_*`` bucket
(``models.common.cost_scope``); this module computes what the *kernel*
would actually move (inputs + outputs + K/V re-streams), so the roofline
can report both:

  memory_raw   — the eager program as counted (the plain versions)
  memory       — kernel regions' traffic replaced by their analytic IO

Assumptions (documented, deliberately simple):
  - train passes move ~3x the forward IO (fwd read/write + bwd re-read of
    inputs under remat + gradient streams);
  - flash attention re-streams K/V once per Q block row (grid order);
  - per-device sizes divide by the shard counts actually achieved by the
    rules (divisibility-checked — replicated dims divide by 1).
"""

from __future__ import annotations

import math

from repro_torch.models.common import ArchConfig


def _shards(rules: dict, mesh_shape: dict, logical: str, dim: int) -> int:
    axis = rules.get(logical)
    if axis is None:
        return 1
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    size = math.prod(mesh_shape.get(a, 1) for a in axes)
    return size if size > 0 and dim % size == 0 else 1


def kernel_io_bytes(
    cfg: ArchConfig,
    kind: str,  # train | prefill | decode
    seq_len: int,
    global_batch: int,
    mesh_shape: dict,
    rules: dict,
) -> dict:
    """Per-device analytic IO bytes per step for each pallas bucket."""
    B, L = global_batch, seq_len
    bpe = 2  # bf16 activations
    mult = 3.0 if kind == "train" else 1.0
    out: dict = {}

    b_sh = _shards(rules, mesh_shape, "batch", B)

    # ---- flash attention ----------------------------------------------------
    n_attn = sum(1 for s in cfg.layer_specs() if s.mixer == "attention")
    if cfg.encoder_layers:
        n_attn += cfg.encoder_layers + cfg.n_layers  # encoder self + cross
    if n_attn:
        if cfg.attention == "mla":
            # reconstituted per-head KV shards with the (padded) q heads
            H = KVH = cfg.n_heads_eff
            dk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
            h_sh = kvh_sh = _shards(rules, mesh_shape, "heads", H)
        else:
            H, KVH = cfg.n_heads_eff, cfg.n_kv_heads
            dk = dv = cfg.head_dim
            h_sh = _shards(rules, mesh_shape, "heads", H)
            kvh_sh = _shards(rules, mesh_shape, "kv_heads", KVH)

        if kind in ("train", "prefill"):
            q = B * L * H * dk * bpe / (b_sh * h_sh)
            o = B * L * H * dv * bpe / (b_sh * h_sh)
            kv = B * L * KVH * (dk + dv) * bpe / (b_sh * kvh_sh)
            nq_rows = max(1, L // max(cfg.block_q, 1))
            restream = (nq_rows - 1) * kv
            if cfg.window and cfg.attention == "swa":
                # SWA only re-streams the in-window KV stripe
                restream = (nq_rows - 1) * kv * min(1.0, cfg.window / L)
            elif cfg.causal_skip:
                restream *= 0.5  # q-row i reads only the causal prefix
            out["pallas_flash_attention"] = mult * n_attn * (q + o + kv + restream)
        else:  # decode: dominated by one full KV-cache read per layer
            S = min(L, cfg.window) if (cfg.attention == "swa" and cfg.window) else L
            seq_sh = _shards(rules, mesh_shape, "kv_seq", S)
            kv = B * S * KVH * (dk + dv) * bpe / (b_sh * kvh_sh * seq_sh)
            out["pallas_flash_attention"] = n_attn * kv

    # ---- mamba selective scan -------------------------------------------------
    n_mamba = sum(1 for s in cfg.layer_specs() if s.mixer == "mamba")
    if n_mamba and kind != "decode":
        Di, N = cfg.d_inner, cfg.ssm_state
        i_sh = _shards(rules, mesh_shape, "inner", Di)
        io = (B * L * Di * (bpe + 4 + 4) + 2 * B * L * N * 4) / (b_sh * i_sh)
        out["pallas_mamba_scan"] = mult * n_mamba * io
    elif n_mamba:  # decode: state read+write per layer
        Di, N = cfg.d_inner, cfg.ssm_state
        i_sh = _shards(rules, mesh_shape, "inner", Di)
        out["pallas_mamba_scan"] = n_mamba * 2 * B * Di * N * 4 / (b_sh * i_sh)

    # ---- moe grouped matmul ---------------------------------------------------
    n_moe = sum(1 for s in cfg.layer_specs() if s.ffn == "moe")
    if n_moe:
        from repro_torch.models.moe import expert_capacity

        E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
        T = B * (L if kind != "decode" else 1)
        Gd = max(1, cfg.moe_groups)  # group-local dispatch groups
        Tg = T // Gd
        C = expert_capacity(Tg, cfg)  # matches the runtime dispatch bins
        e_sh = _shards(rules, mesh_shape, "experts", E)
        f_sh = _shards(rules, mesh_shape, "mlp", F) if e_sh == 1 else 1
        g_sh = _shards(rules, mesh_shape, "moe_group", Gd)
        groups_per_dev = max(1, Gd // g_sh)
        acts = 2 * groups_per_dev * E * C * D * bpe / e_sh
        weights = 3 * E * D * F * bpe / (e_sh * f_sh)
        out["pallas_moe_gmm"] = mult * n_moe * (acts + weights)

    return out


def apply_kernel_credit(
    raw_traffic: float,
    buckets: dict,
    io: dict,
) -> dict:
    """memory term substitution. Returns details + corrected bytes."""
    credited = raw_traffic
    detail = {}
    for name, kio in io.items():
        braw = buckets.get(name, {}).get("traffic_bytes", 0.0)
        credited = credited - braw + kio
        detail[name] = {"raw_bytes": braw, "kernel_io_bytes": kio}
    return {"corrected_traffic": max(credited, 0.0), "detail": detail}
