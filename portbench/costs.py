"""The yardstick's arithmetic: operations and bytes of each kernel call and
of each whole step, and the chip's published peaks.

A frozen copy: it imports nothing of the port, and later changes to the
port's own counts (``repro_torch/roofline/``) do not move it. Sources:

- Peaks: NVIDIA's H100 SXM data sheet, dense rates: 989e12 FLOP/s in bf16
  on the tensor cores, 67e12 FLOP/s in f32 outside them, 3.35e12 B/s of HBM3.
- Attention (``flash_attention``): 2 B H pairs (Dk + Dv) operations, the
  two products over the causal pairs L (L + 1) / 2 of each head (PERF.md's
  kernel table; ``repro_torch/roofline/op_costs.py`` counts the same).
- ``moe_gmm``: 6 D F operations for each kept token-slot (gate, up and
  down products); each touched expert's three weights read once, each kept
  slot's row read and written once: the work the routed tokens need, not
  the capacity bins.
- ``mamba_scan``: per (b, t, channel, state) 6 operations (dt a, the decay
  times h, dt x B, the add, h C and its sum) in f32; bytes: xc, dt and the
  f32 output y per (b, t, channel), B and C per (b, t, state), A, the
  final state, and the carried-in state where one is given.
- Whole steps: 2 N operations a token, N the parameters that multiply
  (embedding rows are gathered, not multiplied); attention's products
  beside them (2 (Dk + Dv) a head and causal pair at prefill), each block's
  from its file (``portbench/blocks/``; MLA's says which of its two forms
  it counts at each phase, and why).

Byte counts take each input read once and each output written once.
"""

from __future__ import annotations

from portbench import blocks

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_NAME = "NVIDIA H100 SXM data sheet (dense, 700 W)"


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def causal_pairs(L: int) -> int:
    return L * (L + 1) // 2


def attention_fwd(B: int, H: int, KVH: int, L: int, Dk: int, Dv: int, elt: int = 2, lse: bool = False) -> tuple:
    """(flops, bytes) of one causal self-attention call at L queries and keys."""
    flops = 2 * B * H * causal_pairs(L) * (Dk + Dv)
    nbytes = elt * B * L * (H * Dk + KVH * (Dk + Dv) + H * Dv) + (4 * B * H * L if lse else 0)
    return flops, nbytes


def moe_gmm(kept_slots: float, experts_touched: int, D: int, F: int, elt: int = 2) -> tuple:
    """(flops, bytes) of one grouped SwiGLU call."""
    return 6.0 * kept_slots * D * F, elt * (experts_touched * 3 * D * F + 2 * kept_slots * D)


def mamba_scan(B: int, L: int, Di: int, N: int, x_elt: int = 2, h0: bool = False) -> tuple:
    """(flops, bytes) of one selective scan; its bound is taken against the
    f32 rate (``bound_s(..., PEAK_F32_FLOPS)``)."""
    flops = 6 * B * L * Di * N
    nbytes = B * L * Di * (x_elt + 4 + 4) + B * L * 2 * N * 4 + Di * N * 4 + B * Di * N * 4 * (2 if h0 else 1)
    return flops, nbytes


# ---------------------------------------------------------------------------
# Whole steps, from a configuration file's sizes
# ---------------------------------------------------------------------------


def _blocks(cfg: dict) -> list:
    """The block module of every slot of every layer."""
    return [block for layer in blocks.layers(cfg) for _, _, block in layer]


def matmul_params(cfg: dict, active: bool = True, head: bool = True) -> int:
    """Parameters that multiply a token: every layer's products (the top-k
    experts where ``active``), the output head where ``head``; norms and the
    embedding's gathered rows are not products."""
    total = sum(block.products(cfg, active) for block in _blocks(cfg))
    if head:
        total += cfg["hidden_size"] * cfg["vocab_size"]
    return total


def attention_shapes(cfg: dict) -> list:
    """(H, KVH, Dk, Dv) of each layer's causal attention at prefill."""
    return [block.attention_shape(cfg) for block in _blocks(cfg) if hasattr(block, "attention_shape")]


def routed_slots(cfg: dict) -> int:
    """Expert slots a token takes over the layers."""
    return sum(block.routed(cfg) for block in _blocks(cfg) if hasattr(block, "routed"))


def prefill_flops(cfg: dict, B: int, L: int) -> float:
    """2 N_active B L over the layers, each attention's causal products (2 B
    H pairs (Dk + Dv)), and the head at the last position only (the port's
    prefill keeps those logits)."""
    attn = sum(2 * B * H * causal_pairs(L) * (dk + dv) for H, _, dk, dv in attention_shapes(cfg))
    return 2.0 * matmul_params(cfg, head=False) * B * L + attn + 2.0 * B * cfg["hidden_size"] * cfg["vocab_size"]


def decode_step(cfg: dict, B: int, context: float, elt: int = 2) -> tuple:
    """(flops, bytes) of one decode step of B tokens against ``context``
    cached positions: every weight that multiplies read once (all experts,
    each touched at these batches), the embedding's B rows, and each block's
    own (``decode_extra``: attention's products and the cache it reads, a
    state read and written)."""
    extra = [block.decode_extra(cfg, B, context, elt) for block in _blocks(cfg) if hasattr(block, "decode_extra")]
    flops = 2.0 * matmul_params(cfg) * B + sum(f for f, _ in extra)
    nbytes = elt * matmul_params(cfg, active=False) + elt * B * cfg["hidden_size"] + sum(b for _, b in extra)
    return flops, nbytes
