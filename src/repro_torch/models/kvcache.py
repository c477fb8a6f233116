"""KV caches for serving: the contiguous slot cache, the prefix block pool,
the paged pool, their reads and writes, and decode attention over them.

The counterpart of ``repro.models.kvcache``.  Two layouts:

* **contiguous** — ``{"k","v"}: (L, B, Hkv, T, D)`` in the slot-cache
  dtype plus ``length``: a scalar (all rows in lockstep, the wave path,
  ring buffers allowed) or a per-slot ``(B,)`` vector (continuous
  batching: each row is a slot with its own length, re-primed by
  :func:`insert_slot_kv`);
* **paged** — a LAYER-major pool ``(L, num_pages + 1, Hkv, block_size,
  D)`` in the compute dtype, so ``pool[l]`` is one contiguous layer the
  kernels read directly.  The last row is the TRASH page: writes of slots
  that are not live are redirected there, so a scatter can run for the
  whole slot batch unconditionally; the trash row is never read as data.

Where JAX returns updated arrays (and the engine donates the old ones),
these functions write the tensors in place and never rebind them: the
serve engine's decode graphs replay over their addresses.  Where JAX's
``dynamic_update_slice`` clamps a start so the update fits, these clamp
it the same way.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_prefill_attention_cuda)

Cache = Dict[str, torch.Tensor]

# storage dtype of the serving KV caches: the contiguous slot cache stores
# it (the cast happens once, at insert), and the decode step reads pages
# through it (see paged_gather_layer), so both layouts read equal values
SLOT_CACHE_DTYPE = torch.bfloat16


def init_kv_cache(
    num_layers: int, batch: int, num_kv_heads: int, max_len: int,
    head_dim: int, dtype: torch.dtype = SLOT_CACHE_DTYPE, *,
    per_slot: bool = False, device: torch.device,
) -> Cache:
    """Contiguous cache: {"k","v"}: (L, B, Hkv, max_len, D), "length": a
    scalar, or (B,) with ``per_slot``."""
    shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
    lshape = (batch,) if per_slot else ()
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros(lshape, dtype=torch.int32, device=device)}


def update_layer_cache(
    k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, length: torch.Tensor, *,
    ring_window: Optional[int] = None,
) -> None:
    """Write (B, Hkv, S_new, D) keys at position ``length`` (one layer), in
    place.  ``length`` is a scalar (every row at one position) or per-slot
    ``(B,)`` (each row at its own — the continuous-batching decode step).
    ``ring_window``: the cache holds that many positions and writes wrap
    (scalar length only).  A start past ``T - S_new`` is clamped to it."""
    B, _, S, _ = k_new.shape
    T = k_cache.shape[2]
    if length.ndim == 1:
        assert ring_window is None, "ring caches are lockstep-only"
        start = torch.clamp(length.long(), 0, T - S)                 # (B,)
        cols = start[:, None] + torch.arange(S, device=length.device)
        rows = torch.arange(B, device=length.device)[:, None]
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            # (B, S) index pairs select (B, S, Hkv, D) values
            cache.transpose(1, 2)[rows, cols] = \
                new.transpose(1, 2).to(cache.dtype)
        return
    pos = length.long() % ring_window if ring_window is not None else length.long()
    cols = torch.clamp(pos, 0, T - S) + torch.arange(S, device=length.device)
    k_cache[:, :, cols] = k_new.to(k_cache.dtype)
    v_cache[:, :, cols] = v_new.to(v_cache.dtype)


def insert_slot_kv(cache: Cache, k_new: torch.Tensor, v_new: torch.Tensor,
                   slot: int, true_len: int) -> Cache:
    """Write a prefilled prompt's K/V into decode slot ``slot`` from
    position 0 and set ``length[slot] = true_len`` (the slot-recycling
    contract: stale positions at ``>= true_len`` stay masked until decode
    overwrites them).  k_new/v_new: (L, 1, Hkv, S, D), S may be padded."""
    return insert_slot_kv_at(cache, k_new, v_new, slot, 0, true_len)


def insert_slot_kv_at(cache: Cache, k_new: torch.Tensor, v_new: torch.Tensor,
                      slot: int, start_pos: int, true_len: int) -> Cache:
    """Write K/V (L, 1, Hkv, S, D) into slot ``slot`` from ``start_pos``,
    in place, and set ``length[slot] = true_len`` (the FULL sequence
    length).  The prefix-cache admission writes the cached prefix at 0,
    then the suffix at ``start_pos = prefix_len``.  Returns ``cache``
    (other keys, such as the ``auto`` layout's block table, untouched)."""
    S = k_new.shape[3]
    T = cache["k"].shape[3]
    start = min(max(int(start_pos), 0), T - S)
    for key, new in (("k", k_new), ("v", v_new)):
        cache[key][:, slot, :, start:start + S] = new[:, 0].to(cache[key].dtype)
    cache["length"][slot] = int(true_len)
    return cache


# -- block pool of the contiguous layout's prefix cache ---------------------------
#
# The radix tree (runtime/prefix_cache.py) hands out page ids; these
# functions own the device tensors behind them.  Pages hold the COMPUTE
# dtype: a warm admission hands the suffix prefill the prefix K/V a cold
# prefill computes, and the slot-cache cast happens at insert on both
# paths.

def init_block_pool(num_blocks: int, num_layers: int, num_kv_heads: int,
                    block_size: int, head_dim: int, dtype: torch.dtype,
                    device: torch.device) -> Cache:
    """Pool of KV pages: {"k","v"}: (N, L, Hkv, block_size, D)."""
    shape = (num_blocks, num_layers, num_kv_heads, block_size, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_block(pool: Cache, k_src: torch.Tensor, v_src: torch.Tensor,
                block_id: int, start: int, block_size: int) -> Cache:
    """Copy positions ``[start, start + block_size)`` of a prefill's K/V
    (L, 1, Hkv, S, D) into page ``block_id``, in place (a start past
    ``S - block_size`` is clamped to it)."""
    start = min(max(int(start), 0), k_src.shape[3] - block_size)
    for key, src in (("k", k_src), ("v", v_src)):
        pool[key][block_id] = src[:, 0, :, start:start + block_size].to(
            pool[key].dtype)
    return pool


def gather_blocks(pool: Cache, ids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pages ``ids`` (nb,) as contiguous prefix K/V (L, 1, Hkv, nb*bs, D),
    the layout :func:`insert_slot_kv_at` and the suffix prefill take."""
    def take(p):
        g = p[ids.long()]                            # (nb, L, Hkv, bs, D)
        nb, L, Hkv, bs, D = g.shape
        return g.permute(1, 2, 0, 3, 4).reshape(L, Hkv, nb * bs, D)[:, None]
    return take(pool["k"]), take(pool["v"])


# -- the paged layout -----------------------------------------------------------------

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


def gather_pages(pool: Cache, ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pages ``ids`` (nb,) of the layer-major pool as (L, 1, Hkv, nb*bs,
    D): the layout and values :func:`gather_blocks` gives on the block
    pool, so the suffix prefill reads either alike."""
    def take(p):
        g = p[:, ids.long()]                         # (L, nb, Hkv, bs, D)
        L, nb, Hkv, bs, D = g.shape
        return g.permute(0, 2, 1, 3, 4).reshape(L, Hkv, nb * bs, D)[:, None]
    return take(pool["k"]), take(pool["v"])


def write_pages(pool: Cache, k_src: torch.Tensor, v_src: torch.Tensor,
                ids: torch.Tensor, starts: torch.Tensor, base: int,
                valid_len: int) -> Cache:
    """Masked scatter of prefill K/V into pages, in place.

    k_src/v_src: (L, 1, Hkv, S_pad, D) covering positions ``[base, base +
    S_pad)``; ``ids`` (nb,): target pages (distinct, apart from repeats of
    the trash id whose whole window is invalid); ``starts`` (nb,):
    each page's block-aligned absolute start; ``valid_len``: the real
    source positions.  Columns whose position falls outside ``[base, base
    + valid_len)`` keep their pool content, so one call serves full
    blocks, a block written from mid-block and a final partial block."""
    bs = pool["k"].shape[3]
    dev = pool["k"].device
    ids = ids.long().to(dev)
    src = starts.long().to(dev)[:, None] + torch.arange(bs, device=dev) - base
    valid = (src >= 0) & (src < valid_len)                     # (nb, bs)
    idx = torch.clamp(src, 0, k_src.shape[3] - 1)
    sel = valid[None, :, None, :, None]
    for key, src_arr in (("k", k_src), ("v", v_src)):
        arr = pool[key]
        vals = src_arr[:, 0][:, :, idx]                # (L, Hkv, nb, bs, D)
        vals = vals.permute(0, 2, 1, 3, 4).to(arr.dtype)
        arr[:, ids] = torch.where(sel, vals, arr[:, ids])
    return pool


def copy_page(pool: Cache, src: int, dst: int) -> None:
    """Copy-on-write: duplicate page ``src`` into ``dst`` (all layers), in
    place."""
    for arr in (pool["k"], pool["v"]):
        arr[:, dst] = arr[:, src]


def swap_out_pages(pool: Cache, ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preemption swap-out: a victim's filled pages ``ids`` (nb,) copied to
    host memory as (k, v) of shape (L, 1, Hkv, nb*bs, D), pages
    concatenated in ``ids`` order — :func:`gather_pages`, the layout
    :func:`swap_in_pages` scatters back from.  ``ids`` may be padded by
    repeating a valid id.  On the card the copy goes to pinned memory and
    is fenced before this returns, so the pages can be given away; on the
    CPU the gather is already a copy the pool's later writes cannot
    reach."""
    k, v = gather_pages(pool, ids)
    if k.device.type != "cuda":
        return k, v
    host = []
    for t in (k, v):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    torch.cuda.current_stream(k.device).synchronize()
    return host[0], host[1]


def swap_in_pages(pool: Cache, k_host: torch.Tensor, v_host: torch.Tensor,
                  ids: torch.Tensor, starts: torch.Tensor,
                  valid_len: int) -> Cache:
    """Preemption swap-in: scatter a :func:`swap_out_pages` result, which
    covers positions ``[0, nb*bs)``, into fresh pages ``ids`` in place.
    ``starts`` are their block-aligned starts; padding takes the trash id
    and a negative start, so its whole window is invalid and the trash row
    is rewritten with its own content.  ``valid_len`` is the preempted
    residency's filled length: a half-filled tail block's other columns
    keep the pool's content, as a chunk written from mid-block would."""
    dev = pool["k"].device
    return write_pages(pool, k_host.to(dev, non_blocking=True),
                       v_host.to(dev, non_blocking=True), ids, starts, 0,
                       valid_len)


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


def append_tokens_paged(
    pool_k_l: torch.Tensor, pool_v_l: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, block_table: torch.Tensor, length: torch.Tensor,
    write_mask: torch.Tensor, trash: int,
) -> None:
    """Write a SPAN of decode-position K/V into each slot's pages (one
    layer), in place — the multi-position :func:`append_token_paged` of the
    speculative verify pass: candidate ``j`` of slot ``i`` lands at
    position ``length[i] + j``.

    k_new/v_new: (B, Hkv, S, D); ``write_mask`` (B, S) selects the real
    writes, everything else (free slots, candidates past a slot's token
    budget) goes to the trash page.  The engine reserves pages covering
    every real write, so those land in pages the slot owns privately and
    never collide; trash collisions are harmless (the row is never read).
    Positions come from ``length`` on the device, so the call can be
    captured in a CUDA graph."""
    B, _, S, _ = k_new.shape
    bs = pool_k_l.shape[2]
    nb = block_table.shape[1]
    pos = length.long()[:, None] + torch.arange(S, device=length.device)
    col = torch.clamp(pos // bs, 0, nb - 1)
    page = torch.where(write_mask > 0,
                       torch.gather(block_table.long(), 1, col),
                       torch.full_like(pos, trash))
    off = pos % bs
    for pool, new in ((pool_k_l, k_new), (pool_v_l, v_new)):
        pool[page, :, off] = new.transpose(1, 2).to(pool.dtype)  # (B, S, Hkv, D)


def update_layer_cache_multi(
    k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, length: torch.Tensor, write_mask: torch.Tensor,
) -> None:
    """Masked multi-position write into a per-slot contiguous cache, in
    place — the contiguous twin of :func:`append_tokens_paged` for the
    ``auto`` layout's verify pass.  k_new/v_new: (B, Hkv, S, D) at positions
    ``length[i] + j``; ``write_mask`` (B, S).

    A masked-off position is dropped, never clamped (a clamped write near
    ``max_len`` would slide back over committed positions), as the
    reference's ``mode="drop"`` scatter does.  Here every position of a row
    is written at ``(length + j) % T``, the real ones with the new value
    and the masked ones with the value already there: a real position
    lies in ``[length, T)`` and a wrapped one below ``length``, so the
    (slot, position) pairs are distinct (S <= T) and the masked writes
    change nothing."""
    B, Hkv, T, D = k_cache.shape
    S = k_new.shape[2]
    assert S <= T, (S, T)
    idx = (length.long()[:, None] + torch.arange(S, device=length.device)) % T
    rows = torch.arange(B, device=length.device)[:, None]
    keep = (write_mask > 0)[:, :, None, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        c = cache.transpose(1, 2)                       # (B, T, Hkv, D) view
        c[rows, idx] = torch.where(keep, new.transpose(1, 2).to(cache.dtype),
                                   c[rows, idx])


def spec_verify_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    length: torch.Tensor, *, window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-query decode attention of the speculative verify pass.

    q: (B, Hq, S, D), row ``j`` at position ``length[i] + j``; k/v_cache:
    (B, Hkv, T, D) with the span's own keys already written (write, then
    attend).  Row ``j`` keeps ``col <= length + j`` (and the window): with
    S = 1 this is :func:`decode_attention`'s mask, and the grouped layout
    with f32 scores and the probabilities cast to the cache dtype are the
    same, so a verified row's logits are the sequential step's."""
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k_cache.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, group, S, D).float()
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k_cache.float()) * scale
    row = length.long()[:, None] + torch.arange(S, device=length.device)  # (B, S)
    col = torch.arange(T, device=length.device)
    mask = col[None, None, :] <= row[:, :, None]                          # (B, S, T)
    if window is not None:
        mask &= col[None, None, :] > row[:, :, None] - window
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, S, D).to(q.dtype)


def _decode_mask(length: torch.Tensor, T: int, *, window: Optional[int],
                 ring_window: Optional[int] = None) -> torch.Tensor:
    """(1-or-B, 1, 1, 1, T) validity mask for single-position attention:
    per-slot lengths give B rows, a scalar length one."""
    ln = length.long()
    if ln.ndim == 1:
        assert ring_window is None, "ring caches are lockstep-only"
        ln = ln[:, None, None, None, None]
    col = torch.arange(T, device=length.device)[None, None, None, None, :]
    if ring_window is not None:
        # every ring slot written so far holds a key inside the window
        return col < torch.clamp(ln + 1, max=T)
    mask = col <= ln  # include the token being decoded
    if window is not None:
        mask &= col > ln - window
    return mask


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    length: torch.Tensor, *, window: Optional[int] = None,
    scale: Optional[float] = None, ring_window: Optional[int] = None,
) -> torch.Tensor:
    """Single-position GQA attention against a cache.

    q: (B, Hq, 1, D); k/v_cache: (B, Hkv, T, D); columns past ``length``
    are masked — a scalar (lockstep batch) or each slot's own ``(B,)``.
    A ring cache (``ring_window``, lockstep only) keeps every slot written
    so far.  No repeat of the cache to Hq heads; scores and
    accumulators in f32, the probabilities cast to the cache dtype before
    the value product (as the reference does)."""
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k_cache.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, group, S, D).float()
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k_cache.float()) * scale
    s = s.masked_fill(~_decode_mask(length, T, window=window,
                                    ring_window=ring_window), float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, S, D).to(q.dtype)


def decode_attention_flat(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    length: torch.Tensor, *, window: Optional[int] = None,
    scale: Optional[float] = None, ring_window: Optional[int] = None,
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
    mask = _decode_mask(length, T, window=window, ring_window=ring_window)
    s = s.masked_fill(~mask.reshape(mask.shape[0], 1, 1, T), float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def decode_attention_cuda(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    length: torch.Tensor, *, window: Optional[int] = None,
    scale: Optional[float] = None, ring_window: Optional[int] = None,
) -> torch.Tensor:
    """The ``cuda`` decode variant on a contiguous cache.  The kernel reads
    pages through a block table; a contiguous (B, Hkv, T, D) cache has
    none, so this rung is :func:`decode_attention` (as the reference's
    ``decode_attention_pallas`` is).  The paged steps call the kernel
    itself (:func:`paged_decode_attention_kernel`)."""
    return decode_attention(q, k_cache, v_cache, length, window=window,
                            scale=scale, ring_window=ring_window)


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


# The serve engine's decode VPE axis (first = default): attention over a
# contiguous cache or gathered pages.  "cuda" scores pages in place through
# the kernel on the paged data path; on a contiguous cache it is grouped.
DECODE_ATTN_VARIANTS = {
    "grouped": decode_attention,
    "flat": decode_attention_flat,
    "cuda": decode_attention_cuda,
}

# Variant names that score pages in place through the CUDA kernel instead
# of gathering them.
PAGED_KERNEL_IMPLS = ("cuda",)
