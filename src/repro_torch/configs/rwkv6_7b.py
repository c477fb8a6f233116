"""rwkv6-7b (Finch) — attention-free, data-dependent decay.

[arXiv:2404.05892; hf]  32L d_model=4096 d_ff=14336 vocab=65536.
State is O(1) in sequence length -> runs long_500k.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,           # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    source="arXiv:2404.05892; hf",
)
