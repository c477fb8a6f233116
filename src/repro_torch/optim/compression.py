"""Gradient compression: int8 quantization with error feedback.

The counterpart of the optimizer-side half of ``repro.optim.compression``:
:func:`quantize`/:func:`dequantize` and :class:`ErrorFeedback`, the
numerics of compressed gradient sync applied before the optimizer.  The
wire form, ``compressed_psum`` (an int8 all-reduce across a mesh axis),
waits for the port's mesh (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.utils import _pytree as pytree


def quantize(x: torch.Tensor, *, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization.  Returns (q, scales): q is
    (n_blocks, block) int8, scales (n_blocks, 1) f32."""
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


class ErrorFeedback:
    """EF-SGD style residual: compress(g + e); e' = (g + e) - decompressed."""

    @staticmethod
    def init(params: Any) -> Any:
        return pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)

    @staticmethod
    def apply(grads: Any, residual: Any, *, block: int = 256) -> Tuple[Any, Any]:
        g_leaves, spec = pytree.tree_flatten(grads)
        comp, res = [], []
        for g, e in zip(g_leaves, pytree.tree_leaves(residual)):
            tot = g.float() + e
            q, s = quantize(tot, block=block)
            deq = dequantize(q, s, g.shape)
            comp.append(deq)
            res.append(tot - deq)
        return pytree.tree_unflatten(comp, spec), pytree.tree_unflatten(res, spec)
