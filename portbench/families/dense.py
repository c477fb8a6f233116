"""The dense family: a decoder-only transformer (GQA, RoPE, optional per-head
q/k RMSNorm, SwiGLU FFN, RMSNorm, untied LM head).  A configuration file
under ``configs/`` read into the sizes the reference, the weights and the
work counts use, and into the port's ``ModelConfig``."""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, List, Optional

from portbench import work
from portbench.weights import Spec


@dataclasses.dataclass(frozen=True)
class Dims:
    family: ClassVar[str] = "dense"
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
        name=d.name, family=d.family, num_layers=d.num_layers,
        d_model=d.d_model, num_heads=d.num_heads, num_kv_heads=d.num_kv_heads,
        d_ff=d.d_ff, vocab_size=d.vocab_size, head_dim=d.head_dim,
        qkv_bias=d.qkv_bias, qk_norm=d.qk_norm, window=d.window,
        rope_theta=d.rope_theta, rms_eps=d.rms_eps,
        tie_embeddings=d.tie_embeddings, dtype=d.dtype, **extra)


def leaf_specs(d: Dims) -> List[Spec]:
    """Every leaf in the port's layout: top-level leaves, and the per-layer
    weights stacked on a leading L axis under ``layers/``."""
    L, dm, f = d.num_layers, d.d_model, d.d_ff
    hq, hkv, hd = d.num_heads, d.num_kv_heads, d.head_dim
    specs: List[Spec] = [
        ("embed", (d.vocab_size, dm), "embed", None),
        ("final_norm", (dm,), "ones", None),
        ("layers/ln1", (L, dm), "ones", None),
        ("layers/ln2", (L, dm), "ones", None),
        ("layers/attn_wq", (L, dm, hq * hd), "normal", None),
        ("layers/attn_wk", (L, dm, hkv * hd), "normal", None),
        ("layers/attn_wv", (L, dm, hkv * hd), "normal", None),
        ("layers/attn_wo", (L, hq * hd, dm), "normal", None),
    ]
    if d.qkv_bias:
        raise ValueError("qkv_bias is not part of any configuration here")
    if d.qk_norm:
        specs += [("layers/attn_q_norm", (L, hd), "ones", None),
                  ("layers/attn_k_norm", (L, hd), "ones", None)]
    specs += [("layers/ffn_w_gate", (L, dm, f), "normal", None),
              ("layers/ffn_w_up", (L, dm, f), "normal", None),
              ("layers/ffn_w_down", (L, f, dm), "normal", None)]
    if not d.tie_embeddings:
        specs.append(("lm_head", (dm, d.vocab_size), "normal", None))
    return specs


def attention_params(d: Dims) -> int:
    """Weights one token multiplies in one layer's attention projections."""
    return d.d_model * d.head_dim * (2 * d.num_heads + 2 * d.num_kv_heads)


def layer_matmul_params(d: Dims) -> int:
    """Weights one token multiplies in one layer (attention projections and
    the SwiGLU FFN)."""
    return attention_params(d) + 3 * d.d_model * d.d_ff


def token_flops(d: Dims, context: int, logits: bool) -> int:
    return decoder_token_flops(d, layer_matmul_params(d), context, logits)


def decoder_token_flops(d: Dims, layer_params: int, context: int, logits: bool) -> int:
    """Model FLOPs of one token through a decoder whose every layer
    multiplies ``layer_params`` weights: 2 per weight multiplied, attention
    over ``context`` keys in every layer, and the LM head where the token's
    logits are needed."""
    flops = 2 * layer_params * d.num_layers
    flops += work.attention_flops(context, d.num_heads, d.head_dim) * d.num_layers
    if logits:
        flops += 2 * d.d_model * d.vocab_size
    return flops
