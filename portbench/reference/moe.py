"""The moe family's reference: the dense decoder with every layer's FFN a
mixture of experts, in plain PyTorch, f32 with TF32 off (:mod:`.common`).

Dropless, as the published models are: every token's k experts are
computed, whatever the port's capacity.  The router's product stays f32 in
the fp8 control too (the port keeps the router in f32); the experts' and the
shared expert's products are rounded there as every other weight product.
``cfg`` is :class:`portbench.families.moe.Dims` or any object with its
fields.  The family trains in no cell: there is no loss here.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.common import attention_block, decoder_logits, linear, rmsnorm


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, precision: str) -> torch.Tensor:
    return linear(F.silu(linear(x, w_gate, precision)) * linear(x, w_up, precision),
                  w_down, precision)


def moe(cfg, p: Dict[str, torch.Tensor], h: torch.Tensor, precision: str) -> torch.Tensor:
    """The MoE block on h (S, d): softmax router, top-k (renormalised where
    ``cfg.norm_topk_prob``), each expert's SwiGLU over the rows routed to
    it, weighted by their gates, plus the shared SwiGLU."""
    gates = torch.softmax(h @ p["moe_router"], dim=-1)
    weights, experts = torch.topk(gates, cfg.top_k, dim=-1)
    if cfg.norm_topk_prob:
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(cfg.num_experts):
        rows, k = torch.nonzero(experts == e, as_tuple=True)
        if rows.numel():
            y = swiglu(h[rows], p["moe_experts_gate"][e], p["moe_experts_up"][e],
                       p["moe_experts_down"][e], precision)
            out = out.index_add(0, rows, y * weights[rows, k, None])
    if cfg.num_shared_experts:
        out = out + swiglu(h, p["moe_shared_w_gate"], p["moe_shared_w_up"],
                           p["moe_shared_w_down"], precision)
    return out


def layer(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, positions: torch.Tensor,
          precision: str) -> torch.Tensor:
    """One layer on x (S, d) in f32."""
    x = attention_block(cfg, p, x, positions, precision)
    return x + moe(cfg, p, rmsnorm(x, p["ln2"], cfg.rms_eps), precision)


def serve_logits(cfg, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 start: int, precision: str = "f32") -> torch.Tensor:
    """Logits (S - start, V) in f32 of positions ``start`` .. S - 1 of one
    sequence ``tokens`` (S,): row j predicts the token after position
    ``start + j``."""
    return decoder_logits(layer, cfg, params, tokens, start, precision)
