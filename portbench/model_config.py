"""A configuration file under ``configs/`` read into the sizes the reference
and the work counts use, and into the port's ``ModelConfig``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    rms_eps: float
    qk_norm: bool
    qkv_bias: bool
    tie_embeddings: bool
    window: Optional[int]
    dtype: str

    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        layer = 2 * d + d * hd * (2 * self.num_heads + 2 * self.num_kv_heads)
        layer += 3 * d * self.d_ff + (2 * hd if self.qk_norm else 0)
        head = 0 if self.tie_embeddings else d * self.vocab_size
        return self.num_layers * layer + self.vocab_size * d + d + head


def dims(conf: Dict) -> Dims:
    return Dims(
        name=conf["name"],
        num_layers=int(conf["num_hidden_layers"]),
        d_model=int(conf["hidden_size"]),
        num_heads=int(conf["num_attention_heads"]),
        num_kv_heads=int(conf["num_key_value_heads"]),
        head_dim=int(conf["head_dim"]),
        d_ff=int(conf["intermediate_size"]),
        vocab_size=int(conf["vocab_size"]),
        rope_theta=float(conf["rope_theta"]),
        rms_eps=float(conf["rms_norm_eps"]),
        qk_norm=bool(conf["qk_norm"]),
        qkv_bias=bool(conf["attention_bias"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]),
        window=conf["sliding_window"],
        dtype=str(conf["torch_dtype"]),
    )


def port_config(conf: Dict, d: Optional[Dims] = None):
    """The port's ``ModelConfig`` for this file, with the implementation
    pins of its ``port`` section."""
    from repro_torch.configs.base import ModelConfig
    d = d or dims(conf)
    port = conf.get("port", {})
    extra = {k: port[k] for k in ("attn_impl", "remat") if k in port}
    return ModelConfig(
        name=d.name, family=port.get("family", "dense"), num_layers=d.num_layers,
        d_model=d.d_model, num_heads=d.num_heads, num_kv_heads=d.num_kv_heads,
        d_ff=d.d_ff, vocab_size=d.vocab_size, head_dim=d.head_dim,
        qkv_bias=d.qkv_bias, qk_norm=d.qk_norm, window=d.window,
        rope_theta=d.rope_theta, rms_eps=d.rms_eps,
        tie_embeddings=d.tie_embeddings, dtype=d.dtype, **extra)
