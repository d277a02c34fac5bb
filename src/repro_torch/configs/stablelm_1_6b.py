"""StableLM 2 1.6B — dense MHA transformer (kv heads == heads).

[hf:stabilityai/stablelm-2-1_6b] 24 layers, d_model 2048, 32 heads (kv=32),
d_ff 5632, vocab 100352. Full attention => long_500k SKIPPED.
"""

from repro_torch.models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    layout=(LayerSpec(mixer="attention", ffn="dense"),),
    attention="full",
)
