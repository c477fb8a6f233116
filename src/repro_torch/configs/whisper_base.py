"""whisper-base — encoder-decoder, conv audio frontend STUBBED.

[arXiv:2212.04356; unverified]  6L+6L d_model=512 8H (kv=8) d_ff=2048
vocab=51865, source_len=1500 frames.  input_specs() provides the
precomputed frame embeddings (the conv frontend is a stub per brief).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=12,          # 6 enc + 6 dec (bookkeeping total)
    encoder_layers=6,
    decoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    qkv_bias=True,
    source_len=1500,
    source="arXiv:2212.04356; unverified",
)
