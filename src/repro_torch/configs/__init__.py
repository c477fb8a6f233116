"""Architecture registry of the port: ``get_config(name)`` / ``ARCHS``.

The dense architectures the port serves; each module is a copy of its
``repro.configs`` counterpart.
"""

from __future__ import annotations

from .base import ModelConfig
from .h2o_danube_3_4b import CONFIG as h2o_danube_3_4b
from .qwen2_7b import CONFIG as qwen2_7b
from .qwen3_8b import CONFIG as qwen3_8b

ARCHS = {c.name: c for c in (qwen2_7b, qwen3_8b, h2o_danube_3_4b)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get_config", "ModelConfig"]
