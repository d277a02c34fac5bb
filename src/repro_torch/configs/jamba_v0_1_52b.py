"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887] 32 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 65536, MoE 16 experts top-2 applied every other layer; one attention
layer per 8-layer block (attn:mamba = 1:7), attention at in-block index 4.
Sub-quadratic (SSM-dominated) => runs long_500k.
"""

from repro_torch.models.common import ArchConfig, LayerSpec

_LAYOUT = tuple(
    LayerSpec(
        mixer="attention" if i == 4 else "mamba",
        ffn="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    layout=_LAYOUT,
    attention="full",
    n_experts=16,
    top_k=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)
