"""Phi-3.5-MoE 42B (6.6B active) — 16-expert top-2 MoE transformer.

[hf:microsoft/Phi-3.5-MoE-instruct] 32 layers, d_model 4096, 32 heads
(GQA kv=8), d_ff 6400 per expert, vocab 32064, 16 experts top-2.
Full attention => long_500k SKIPPED per assignment.
"""

from repro_torch.models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="phi3.5-moe-42b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    layout=(LayerSpec(mixer="attention", ffn="moe"),),
    attention="full",
    n_experts=16,
    top_k=2,
)
