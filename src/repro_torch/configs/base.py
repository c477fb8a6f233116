"""Config system: one frozen dataclass describes an architecture.

A copy of ``repro.configs.base.ModelConfig`` (field for field, so the two
packages' configs compare equal as dicts); ``family`` selects the model
assembly, as in the reference: dense, moe and vlm (the transformer), ssm
(the RWKV6 stack), hybrid (Mamba2 + one shared attention block) and encdec
(whisper-style, frontend stubbed).  ``reduced()`` derives the
family-preserving smoke config (small width/depth/vocab/experts) the CPU
parity tests run; :class:`ShardConfig` is a mesh rank's.
:class:`ShapeConfig`, :data:`SHAPES` and :func:`shape_applicable` are the
dry run's input-shape cells, copied from the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // num_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None         # sliding-window attention
    rope_theta: float = 1e4
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_pad_experts: int = 0   # pad expert dim to a multiple (EP sharding)
    moe_groups: int = 1        # group-limited routing (align to data shards)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 6                  # hybrid: shared attn period
    # RWKV
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 32
    # enc-dec
    encoder_layers: int = 0
    decoder_layers: int = 0
    source_len: int = 1500               # whisper frame count after conv stub
    # misc
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # implementation selections (VPE static dispatch seeds; the runtime
    # may override through the controller)
    attn_impl: str = "reference"
    ssd_impl: str = "chunked"
    wkv_impl: str = "chunked"
    remat: str = "full"                  # none | full (layer remat policy)
    unroll_layers: bool = False          # dry-run cost probes only
    # citation / provenance tag ([source; verified-tier] from the brief)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # -- derived -----------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the 500k-context decode shape."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def param_count(self) -> int:
        """Analytic total parameter count (embedding included)."""
        from repro_torch.models.model import count_params_from_shapes
        return count_params_from_shapes(self)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k + shared only)."""
        from repro_torch.models.model import count_params_from_shapes
        if self.family != "moe":
            return self.param_count()
        return count_params_from_shapes(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """Family-preserving smoke config (CPU-runnable)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 if self.family != "hybrid" else 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 8),
            num_shared_experts=min(self.num_shared_experts, 2),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32,
            ssm_chunk=16,
            rwkv_head_dim=32,
            rwkv_chunk=8,
            window=min(self.window, 16) if self.window else None,
            encoder_layers=min(self.encoder_layers, 2),
            decoder_layers=min(self.decoder_layers, 2),
            source_len=24,
            attn_every=2,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShardConfig(ModelConfig):
    """A mesh rank's shard-local config (``distributed.sharding.
    shard_config``): ModelConfig's fields at the rank's heads and hidden
    widths, and ``mixer_shards``, the ranks over which the recurrent
    mixer's heads are split (RWKV6's time-mix, Mamba2).  Their specs derive
    the heads from ``d_model``, which the projections' input keeps whole,
    so no ModelConfig field can express the split; a rank's spec divides
    them by this count."""
    mixer_shards: int = 1


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what step to lower and at what size."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int
    num_microbatches: int = 1

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256, num_microbatches=16),
    ShapeConfig("prefill_32k", "prefill", 32768, 32, num_microbatches=1),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-not): full quadratic attention skips the
    524288-token decode."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full quadratic attention at 524288 ctx (skip per brief)"
    return True, ""
