"""MiniCPM3 4B — dense transformer with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B] 62 layers, d_model 2560, 40 heads, d_ff 6400,
vocab 73448. MLA: q_lora_rank 768, kv_lora_rank 256, qk_nope 64, qk_rope 32,
v_head_dim 64 — the KV cache stores the 288-dim latent per token instead of
40x128 per-head KV (a 17x cache-payload compression; the Koalja
"move references, not payloads" insight inside attention).
Full attention => long_500k SKIPPED.
"""

from repro_torch.models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    layout=(LayerSpec(mixer="attention", ffn="dense"),),
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
)
