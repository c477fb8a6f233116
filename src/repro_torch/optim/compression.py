"""Gradient compression: int8 quantization with error feedback.

The counterpart of ``repro.optim.compression``:

* :func:`quantize`/:func:`dequantize` and :class:`ErrorFeedback`, the
  numerics of compressed gradient sync, applied on the optimizer side
  after the f32 gradient sync (what the training loop uses).  On a rank
  of a model-parallel mesh a split leaf is quantized in the WHOLE leaf's
  blocks of ``block`` elements, as the reference's global arrays are: a
  block's scale is the MAX over the model group of each rank's partial
  ``amax`` over its elements in that block (a shard whose runs of the
  whole leaf's flat order are whole blocks needs no collective);
* :func:`compressed_psum`, the wire form: an int8 all-reduce over a
  process group (quantize, the MAX of the scales, requantize against it,
  an int32 sum, dequantize), the reference's ``_compressed_psum_local``.
  A function, not wired into the loop, as in the reference.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
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


def _split_roundtrip(tot: torch.Tensor, whole: Tuple[int, ...],
                     cut: Tuple[int, int, int], group: Any, block: int
                     ) -> torch.Tensor:
    """quantize + dequantize of a rank's slice ``tot`` (f32) of a leaf of
    shape ``whole``, in the whole leaf's blocks: each element's block is
    that of its index in the whole leaf's flat order, the block's scale
    the MAX over ``group`` of every rank's amax in it."""
    dim, start, size = cut
    inner = math.prod(whole[dim + 1:])
    run = size * inner                          # a contiguous run of the whole
    if run % block == 0 and (start * inner) % block == 0 \
            and (whole[dim] * inner) % block == 0:
        q, s = quantize(tot, block=block)       # runs are whole blocks
        return dequantize(q, s, tot.shape)
    flat = tot.reshape(-1)
    i = torch.arange(flat.numel(), device=flat.device)
    g = (i // run) * (whole[dim] * inner) + start * inner + i % run
    blk = g // block
    amax = torch.zeros(-(-math.prod(whole) // block), dtype=torch.float32,
                       device=flat.device)
    amax.scatter_reduce_(0, blk, flat.abs(), reduce="amax")
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)[blk]
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).reshape(tot.shape)


class ErrorFeedback:
    """EF-SGD style residual: compress(g + e); e' = (g + e) - decompressed."""

    @staticmethod
    def init(params: Any) -> Any:
        return pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)

    @staticmethod
    def apply(grads: Any, residual: Any, *, block: int = 256,
              splits: Optional[Sequence[Any]] = None, group: Any = None
              ) -> Tuple[Any, Any]:
        """``splits`` (a mesh rank's), leaf by leaf: None for a leaf the
        rank holds whole, else ``(whole shape, (dim, start, size))`` of its
        slice, quantized in the whole leaf's blocks with scales agreed
        over ``group`` (the model group; None: every rank)."""
        g_leaves, spec = pytree.tree_flatten(grads)
        splits = splits or [None] * len(g_leaves)
        comp, res = [], []
        for g, e, sp in zip(g_leaves, pytree.tree_leaves(residual), splits):
            tot = g.float() + e
            if sp is None:
                q, s = quantize(tot, block=block)
                deq = dequantize(q, s, g.shape)
            else:
                deq = _split_roundtrip(tot, sp[0], sp[1], group, block)
            comp.append(deq)
            res.append(tot - deq)
        return pytree.tree_unflatten(comp, spec), pytree.tree_unflatten(res, spec)


def compressed_psum(x: torch.Tensor, group: Any = None, *, block: int = 256
                    ) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` (a process group; None: every rank)
    with an int8 payload: each rank quantizes its ``x``, the block scales
    are agreed as their MAX over the group, each rank requantizes its
    values against the agreed scale, the integers are summed in int32 and
    dequantized once.  Returns a new f32 tensor of ``x``'s shape."""
    q, scale = quantize(x, block=block)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    requant = torch.clamp(torch.round(q.float() * scale / scale_max),
                          -127, 127).to(torch.int32)
    dist.all_reduce(requant, group=group)
    return dequantize(requant, scale_max, x.shape)
