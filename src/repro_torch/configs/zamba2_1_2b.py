"""zamba2-1.2b — Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf]  38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000, ssm_state=64.  Hybrid structure per DESIGN.md §7: every
6th block is the single SHARED attn+MLP block (6 applications), the
other 32 blocks are Mamba2.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    rope_theta=10000.0,
    source="arXiv:2411.15242; hf",
)
