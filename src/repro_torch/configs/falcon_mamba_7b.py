"""Falcon-Mamba 7B — attention-free Mamba-1 SSM.

[arXiv:2410.05355] 64 layers, d_model 4096, d_inner 8192 (expand 2),
ssm_state 16, conv 4, vocab 65024. No attention, no FFN (the Mamba block is
the whole layer). O(1) decode state => runs decode_32k and long_500k
trivially (no KV cache at all).
"""

from repro_torch.models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    layout=(LayerSpec(mixer="mamba", ffn="none"),),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)
