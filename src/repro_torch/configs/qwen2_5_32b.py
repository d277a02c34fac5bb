"""Qwen2.5 32B — dense GQA transformer with QKV bias.

[hf:Qwen/Qwen2.5-32B] 64 layers, d_model 5120, 40 heads (GQA kv=8),
d_ff 27648, vocab 152064, QKV bias. Full attention => long_500k SKIPPED.
"""

from repro_torch.models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    layout=(LayerSpec(mixer="attention", ffn="dense"),),
    attention="full",
    qkv_bias=True,
    rope_theta=1e6,
)
