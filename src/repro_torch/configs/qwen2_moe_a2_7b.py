"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (kv=16)
d_ff=1408 (per expert) vocab=151936.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,            # shared-expert aggregate (4 x 1408)
    vocab_size=151936,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    qkv_bias=True,
    rope_theta=1000000.0,
    # §Perf hillclimb 2: pad 60 experts -> 64 so the expert dim shards
    # over the 16-way model axis (EP); measured 4.7x lower collective
    # term and 4.4x better roofline fraction vs the per-expert-TP
    # fallback the unpadded config degrades to.
    moe_pad_experts=16,
    # §Perf hillclimb 4: group-limited routing aligned to the 16-way
    # data axis — dispatch scatter/gather stays shard-local; measured
    # 15x less HLO compute and 2.3x less collective on train_4k.
    moe_groups=16,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
