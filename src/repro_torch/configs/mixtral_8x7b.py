"""Mixtral 8x7B — sparse MoE with sliding-window attention.

[arXiv:2401.04088] 32 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 32000, 8 experts top-2 on every layer, SWA window 4096.
Windowed attention (bounded KV) => runs long_500k with a ring cache.
"""

from repro_torch.models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    layout=(LayerSpec(mixer="attention", ffn="moe"),),
    attention="swa",
    window=4096,
    rope_theta=1e6,
    n_experts=8,
    top_k=2,
)
