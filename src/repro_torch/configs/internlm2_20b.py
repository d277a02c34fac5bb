"""InternLM2 20B — dense GQA transformer.

[arXiv:2403.17297] 48 layers, d_model 6144, 48 heads (GQA kv=8),
d_ff 16384, vocab 92544. Full attention => long_500k SKIPPED.
"""

from repro_torch.models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    layout=(LayerSpec(mixer="attention", ffn="dense"),),
    attention="full",
    rope_theta=1e6,
)
