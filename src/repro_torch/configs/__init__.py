"""Architecture registry of the port: ``get_config(name)`` / ``ARCHS``.

The architectures of every family the reference assembles (dense, moe,
vlm, ssm, hybrid, encdec); each module is a copy of its ``repro.configs``
counterpart.
"""

from __future__ import annotations

from .base import SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeConfig, shape_applicable
from .chameleon_34b import CONFIG as chameleon_34b
from .h2o_danube_3_4b import CONFIG as h2o_danube_3_4b
from .moonshot_v1_16b_a3b import CONFIG as moonshot_v1_16b_a3b
from .qwen2_5_32b import CONFIG as qwen2_5_32b
from .qwen2_7b import CONFIG as qwen2_7b
from .qwen2_moe_a2_7b import CONFIG as qwen2_moe_a2_7b
from .qwen3_8b import CONFIG as qwen3_8b
from .rwkv6_7b import CONFIG as rwkv6_7b
from .whisper_base import CONFIG as whisper_base
from .zamba2_1_2b import CONFIG as zamba2_1_2b

ARCHS = {c.name: c for c in (qwen2_7b, qwen3_8b, h2o_danube_3_4b, qwen2_5_32b,
                             chameleon_34b, qwen2_moe_a2_7b, moonshot_v1_16b_a3b,
                             rwkv6_7b, zamba2_1_2b, whisper_base)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get_config", "ModelConfig", "ShapeConfig", "SHAPES",
           "SHAPES_BY_NAME", "shape_applicable"]
