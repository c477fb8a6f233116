"""chameleon-34b — early-fusion VLM; VQ image tokens are ordinary ids.

[arXiv:2405.09818; unverified]  48L d_model=8192 64H (kv=8) d_ff=22016
vocab=65536 (text + VQ codebook).  Modality frontend is a stub: tokens
arrive pre-quantized, so the backbone is a dense decoder (qk-norm as in
the paper).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    rope_theta=10000.0,
    source="arXiv:2405.09818; unverified",
)
