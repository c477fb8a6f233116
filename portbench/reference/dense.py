"""The dense family's reference: a decoder-only transformer (GQA, RoPE,
optional per-head q/k RMSNorm, SwiGLU, RMSNorm, untied LM head) and its
next-token loss, in plain PyTorch, f32 with TF32 off (:mod:`.common`).

``cfg`` is any object with the fields of the port's ``ModelConfig`` that a
dense model reads (``num_layers``, ``d_model``, ``num_heads``,
``num_kv_heads``, ``head_dim``, ``d_ff``, ``vocab_size``, ``qk_norm``,
``window``, ``rope_theta``, ``rms_eps``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.common import (attention_block, decoder_logits, decoder_loss,
                                        linear, rmsnorm)


def layer(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, positions: torch.Tensor,
          precision: str) -> torch.Tensor:
    """One layer on x (S, d) in f32."""
    x = attention_block(cfg, p, x, positions, precision)
    h = rmsnorm(x, p["ln2"], cfg.rms_eps)
    ff = F.silu(linear(h, p["ffn_w_gate"], precision)) * linear(h, p["ffn_w_up"], precision)
    return x + linear(ff, p["ffn_w_down"], precision)


def serve_logits(cfg, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 start: int, precision: str = "f32") -> torch.Tensor:
    """Logits (S - start, V) in f32 of positions ``start`` .. S - 1 of one
    sequence ``tokens`` (S,): row j predicts the token after position
    ``start + j``."""
    return decoder_logits(layer, cfg, params, tokens, start, precision)


def loss(cfg, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, precision: str = "f32",
         remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy over every position of every row of
    ``tokens`` (B, S), params f32 leaves (autograd through them); each layer
    recomputed in the backward pass when ``remat``."""
    return decoder_loss(layer, cfg, params, tokens, labels, precision, remat)
