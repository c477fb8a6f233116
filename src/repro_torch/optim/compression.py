"""Gradient compression: int8 quantization with error feedback.

The counterpart of ``repro.optim.compression``:

* :func:`quantize`/:func:`dequantize` and :class:`ErrorFeedback`, the
  numerics of compressed gradient sync, applied on the optimizer side
  after the f32 gradient sync (what the training loop uses).  On a rank
  of a model-parallel mesh a split leaf is quantized in the WHOLE leaf's
  blocks of ``block`` elements, as the reference's global arrays are: a
  block's scale is the MAX over the model group of each rank's partial
  ``amax`` over its elements in that block (a shard whose runs of the
  whole leaf's flat order are whole blocks needs no collective); a leaf
  cut on two dims, one over ``model`` and one over ``data`` (fsdp), takes
  the MAX over both groups; the MAX goes through the rank's group object
  (``ShardGroup.all_reduce_``), so the dry run's counting group sees it;
* :func:`compressed_psum`, the wire form: an int8 all-reduce over a
  process group (quantize, the MAX of the scales, requantize against it,
  an int32 sum, dequantize), the reference's ``_compressed_psum_local``.
  A function, not wired into the loop, as in the reference.

Every scale is divided by a tensor on the values' device, never by a
Python number: on CUDA, ``t / 127.0`` multiplies by the rounded
reciprocal of 127, so a value on a rounding boundary lands on the other
int8 neighbour than on the CPU, which divides.
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
    scale = _scale(blocks.abs().amax(dim=1, keepdim=True))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127``, divided on the device (module docstring)."""
    return amax / torch.full_like(amax, 127.0)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def _split_roundtrip(tot: torch.Tensor, whole: Tuple[int, ...],
                     cuts: Sequence[Any], groups: Sequence[Any], block: int,
                     comm: Any = None) -> torch.Tensor:
    """quantize + dequantize of a rank's slice ``tot`` (f32) of a leaf of
    shape ``whole``, in the whole leaf's blocks.  ``cuts``: the cuts that
    made the slice, in order (the model cut on the whole leaf, a (dim,
    start, size) or a ``sharding.Runs``, then the data cut on the model
    shard), and ``groups`` the process group over which each cut's parts
    lie.  Each element's block is that of its index in the whole leaf's
    flat order, the block's scale the MAX over the groups (through the
    rank's group object ``comm``; None: the default process group's) of
    every rank's amax in it."""
    from repro_torch.distributed.sharding import Runs, cut_index
    local = tot.shape
    stride = [math.prod(whole[d + 1:]) for d in range(len(whole))]
    if not any(isinstance(c, Runs) for c in cuts):
        off = [0] * len(whole)
        for dim, start, _ in cuts:
            off[dim] += start
        k = max(d for d, _, _ in cuts)           # the innermost cut dim
        if all(x % block == 0 for x in (local[k] * stride[k], off[k] * stride[k],
                                        whole[k] * stride[k])):
            q, s = quantize(tot, block=block)   # runs are whole blocks
            return dequantize(q, s, tot.shape)
    # each dim's indices in the whole leaf, each cut taken in turn
    index = [torch.arange(n, device=tot.device) for n in whole]
    for cut in cuts:
        dim = cut.dim if isinstance(cut, Runs) else cut[0]
        index[dim] = index[dim][cut_index(cut, tot.device)]
    g = torch.zeros((), dtype=torch.int64, device=tot.device)
    for d in range(len(local)):
        g = g.unsqueeze(-1) + index[d] * stride[d]
    blk = g.reshape(-1) // block
    flat = tot.reshape(-1)
    amax = torch.zeros(-(-math.prod(whole) // block), dtype=torch.float32,
                       device=flat.device)
    amax.scatter_reduce_(0, blk, flat.abs(), reduce="amax")
    for group in groups:
        (comm or _world()).all_reduce_(amax, group=group, op="max")
    scale = _scale(amax)
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
              splits: Optional[Sequence[Any]] = None, group: Any = None,
              data_group: Any = None, comm: Any = None) -> Tuple[Any, Any]:
        """``splits`` (a mesh rank's), leaf by leaf: None for a leaf the
        rank holds whole, else ``(whole shape, model cut, data cut)`` of
        its slice (each cut a (dim, start, size), the model cut also a
        ``sharding.Runs``, or None), quantized in the whole leaf's blocks
        with scales agreed over ``group`` for the model cut (the model
        group; None: every rank) and over ``data_group`` for the data cut,
        through ``comm``, the rank's group object (its ``all_reduce_``;
        None: the default process group's)."""
        g_leaves, spec = pytree.tree_flatten(grads)
        splits = splits or [None] * len(g_leaves)
        comp, res = [], []
        for g, e, sp in zip(g_leaves, pytree.tree_leaves(residual), splits):
            tot = g.float() + e
            if sp is None:
                q, s = quantize(tot, block=block)
                deq = dequantize(q, s, g.shape)
            else:
                whole, cut, data_cut = sp
                cuts = [(c, grp) for c, grp in ((cut, group), (data_cut, data_group))
                        if c is not None]
                deq = _split_roundtrip(tot, whole, [c for c, _ in cuts],
                                       [grp for _, grp in cuts], block, comm)
            comp.append(deq)
            res.append(tot - deq)
        return pytree.tree_unflatten(comp, spec), pytree.tree_unflatten(res, spec)


def _world() -> Any:
    """A group object over the default process group (every rank)."""
    from repro_torch.distributed.group import ShardGroup
    return ShardGroup(dist.get_rank(), dist.get_world_size(), dist.get_backend())


def compressed_psum(x: torch.Tensor, group: Any = None, *, block: int = 256,
                    comm: Any = None) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` (a process group; None: every rank)
    with an int8 payload: each rank quantizes its ``x``, the block scales
    are agreed as their MAX over the group, each rank requantizes its
    values against the agreed scale, the integers are summed in int32 and
    dequantized once.  Both collectives go through ``comm``, the rank's
    group object (None: the default process group's).  Returns a new f32
    tensor of ``x``'s shape."""
    comm = comm or _world()
    q, scale = quantize(x, block=block)
    scale_max = comm.all_reduce_(scale.clone(), group=group, op="max")
    requant = torch.clamp(torch.round(q.float() * scale / scale_max),
                          -127, 127).to(torch.int32)
    comm.all_reduce_(requant, group=group)
    return dequantize(requant, scale_max, x.shape)
