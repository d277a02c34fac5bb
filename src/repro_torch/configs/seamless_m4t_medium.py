"""SeamlessM4T medium — encoder-decoder speech/text model (frontend STUB).

[arXiv:2308.11596] 12 encoder + 12 decoder layers, d_model 1024, 16 heads
(kv=16), d_ff 4096, vocab 256206. The speech frontend is a stub per the
assignment: the encoder consumes 4096 precomputed frame embeddings from
``input_specs()``. Decoder layers carry cross-attention over the encoder
memory. Full self+cross attention => long_500k SKIPPED. Decode shapes decode
the *decoder* against a 4096-frame encoder memory.
"""

from repro_torch.models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    layout=(LayerSpec(mixer="attention", ffn="dense"),),
    attention="full",
    encoder_layers=12,
    cross_attention=True,
    frontend="audio",
    frontend_len=4096,
)
