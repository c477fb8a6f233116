"""Paged KV cache for serving: the page pool, its reads and writes, and
decode attention over it.

The counterpart of the paged half of ``repro.models.kvcache``.  The pool is
LAYER-major — ``(L, num_pages + 1, Hkv, block_size, D)`` — so ``pool[l]`` is
one contiguous layer the kernels read directly.  The last row is the TRASH
page: writes of slots that are not live are redirected there, so a scatter
can run for the whole slot batch unconditionally; the trash row is never
read as data.

Where JAX returns updated arrays (and the engine donates the old ones),
these functions update the pool tensors in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_prefill_attention_cuda)

Cache = Dict[str, torch.Tensor]

# storage dtype of the serving KV reads: the decode step reads pages
# through it (see paged_gather_layer), as the contiguous layout of the
# reference stores them
SLOT_CACHE_DTYPE = torch.bfloat16


def init_page_pool(
    num_pages: int, num_layers: int, num_kv_heads: int, block_size: int,
    head_dim: int, dtype: torch.dtype, device: torch.device,
) -> Cache:
    """Unified paged pool: {"k","v"}: (L, num_pages + 1, Hkv, bs, D).

    ``dtype`` is the model's COMPUTE dtype: a chunk reads earlier chunks'
    K/V back exactly as they were computed."""
    shape = (num_layers, num_pages + 1, num_kv_heads, block_size, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def copy_page(pool: Cache, src: int, dst: int) -> None:
    """Copy-on-write: duplicate page ``src`` into ``dst`` (all layers)."""
    for arr in (pool["k"], pool["v"]):
        arr[:, dst] = arr[:, src]


def write_chunk_paged_layer(
    pool_k_l: torch.Tensor, pool_v_l: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, bt_row: torch.Tensor, base: int, chunk_len: int,
) -> None:
    """Scatter one prefill chunk's K/V into ONE slot's pages (one layer).

    k_new/v_new: (1, Hkv, C_pad, D) covering absolute positions
    ``[base, base + C_pad)``; only the ``chunk_len`` real positions are
    written, each to page ``bt_row[p // bs]`` at offset ``p % bs``;
    everything else keeps its content.  The written (page, offset) pairs
    are distinct, so the scatter has no duplicate targets; the slot's
    pages must cover ``base + chunk_len`` positions.
    """
    bs = pool_k_l.shape[2]
    pos = torch.arange(base, base + chunk_len, device=pool_k_l.device)
    pages = bt_row.long()[pos // bs]
    offs = pos % bs
    for pool, new in ((pool_k_l, k_new), (pool_v_l, v_new)):
        vals = new[0, :, :chunk_len].transpose(0, 1)       # (clen, Hkv, D)
        pool[pages, :, offs] = vals.to(pool.dtype)


def paged_gather_layer(pool_k_l: torch.Tensor, pool_v_l: torch.Tensor,
                       block_table: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linearize one layer's pages through block tables.

    pool_k_l/pool_v_l: (N, Hkv, bs, D); block_table: (B, nb).  Returns
    (B, Hkv, nb*bs, D) where column ``t`` holds absolute position ``t``.
    ``out_dtype``: the decode step passes :data:`SLOT_CACHE_DTYPE`, the
    dtype the reference's decode reads see."""
    def take(p):
        g = p[block_table.long()]                  # (B, nb, Hkv, bs, D)
        B, nb, Hkv, bs, D = g.shape
        g = g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, nb * bs, D)
        return g if out_dtype is None else g.to(out_dtype)
    return take(pool_k_l), take(pool_v_l)


def append_token_paged(
    pool_k_l: torch.Tensor, pool_v_l: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, block_table: torch.Tensor, length: torch.Tensor,
    live: torch.Tensor, trash: int,
) -> None:
    """Write one decode step's K/V into each slot's tail page (one layer).

    k_new/v_new: (B, Hkv, 1, D); ``length`` (B,) is each slot's current
    position.  Non-live slots are redirected to the trash page — their
    block tables may point at pages freed and reallocated to other
    slots.  Several non-live slots may hit the same trash position, and
    which write lands there is unspecified on CUDA; that is harmless only
    because the trash row is never read.
    """
    B = k_new.shape[0]
    bs = pool_k_l.shape[2]
    nb = block_table.shape[1]
    length = length.long()
    col = torch.clamp(length // bs, 0, nb - 1)
    rows = torch.arange(B, device=length.device)
    page = torch.where(live > 0, block_table[rows, col].long(),
                       torch.full_like(length, trash))
    off = length % bs
    pool_k_l[page, :, off] = k_new[:, :, 0].to(pool_k_l.dtype)
    pool_v_l[page, :, off] = v_new[:, :, 0].to(pool_v_l.dtype)


def _decode_mask(length: torch.Tensor, T: int, *,
                 window: Optional[int]) -> torch.Tensor:
    """(B, 1, 1, 1, T) validity mask for single-position attention."""
    ln = length.long()[:, None, None, None, None]
    col = torch.arange(T, device=length.device)[None, None, None, None, :]
    mask = col <= ln  # include the token being decoded
    if window is not None:
        mask &= col > ln - window
    return mask


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    length: torch.Tensor, *, window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-position GQA attention against a per-slot cache.

    q: (B, Hq, 1, D); k/v_cache: (B, Hkv, T, D); columns past each slot's
    ``length`` are masked.  No repeat of the cache to Hq heads; scores and
    accumulators in f32, the probabilities cast to the cache dtype before
    the value product (as the reference does)."""
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k_cache.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, group, S, D).float()
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k_cache.float()) * scale
    s = s.masked_fill(~_decode_mask(length, T, window=window), float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, S, D).to(q.dtype)


def decode_attention_flat(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    length: torch.Tensor, *, window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA-materializing decode attention: repeats K/V up to Hq heads
    before the score product.  Same function as :func:`decode_attention`;
    the alternative layout on the serve engine's VPE axis."""
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k_cache.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    k = torch.repeat_interleave(k_cache, group, dim=1)
    v = torch.repeat_interleave(v_cache, group, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    mask = _decode_mask(length, T, window=window)
    s = s.masked_fill(~mask.reshape(mask.shape[0], 1, 1, T), float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def paged_decode_attention_kernel(
    q: torch.Tensor, pool_k_l: torch.Tensor, pool_v_l: torch.Tensor,
    block_table: torch.Tensor, length: torch.Tensor,
    *, window: Optional[int] = None, scale: Optional[float] = None,
    read_dtype: Optional[torch.dtype] = SLOT_CACHE_DTYPE,
) -> torch.Tensor:
    """Block-indirect decode attention — the ``cuda`` paged backend.

    Same contract as ``decode_attention(q, *paged_gather_layer(...,
    out_dtype=SLOT_CACHE_DTYPE))`` without linearizing the pages;
    ``read_dtype`` defaults to the slot-cache dtype so the kernel scores
    exactly the values the gather path reads (token-parity contract)."""
    return paged_attention_cuda(q, pool_k_l, pool_v_l, block_table, length,
                                window=window, scale=scale,
                                read_dtype=read_dtype)


def paged_prefill_attention_kernel(
    q: torch.Tensor, pool_k_l: torch.Tensor, pool_v_l: torch.Tensor,
    block_table: torch.Tensor, base: torch.Tensor, chunk_len: int,
    *, window: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-query chunk attention over pages — the ``cuda`` prefill
    backend.  The chunk's own K/V must already be in its pages
    (write-then-attend, see ``transformer.prefill_chunk_paged``)."""
    return paged_prefill_attention_cuda(q, pool_k_l, pool_v_l, block_table,
                                        base, chunk_len=chunk_len,
                                        window=window, scale=scale)


# Decode-attention implementations over the gathered pages (first =
# default) — the gather half of the serve engine's decode VPE axis.
DECODE_ATTN_VARIANTS = {
    "grouped": decode_attention,
    "flat": decode_attention_flat,
}

# Variant names that score pages in place through the CUDA kernel instead
# of gathering them (the kernel half of the axis).
PAGED_KERNEL_IMPLS = ("cuda",)
