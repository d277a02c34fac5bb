"""InternVL2 1B — VLM: InternViT frontend (STUB) + Qwen2-0.5B-style LM.

[arXiv:2404.16821] LM backbone: 24 layers, d_model 896, 14 heads (GQA kv=2),
d_ff 4864, vocab 151655. Per the assignment the vision frontend is a stub:
``input_specs()`` provides 1024 precomputed patch embeddings at model dim,
prepended to the token stream. Full attention => long_500k SKIPPED.
14 heads % 16 != 0: sharding falls back to replicated heads (the LM is 1B —
FSDP over embed covers memory).
"""

from repro_torch.models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    layout=(LayerSpec(mixer="attention", ffn="dense"),),
    attention="full",
    qkv_bias=True,
    rope_theta=1e6,
    frontend="vision",
    frontend_len=1024,
)
