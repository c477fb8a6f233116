"""Plain PyTorch versions of the kernels.

The counterparts of ``repro.kernels.ref``: ``matmul_ref`` and
``conv2d_ref``, and ``attention_ref``, ``paged_attention_ref`` and
``paged_prefill_attention_ref``, which materialise the score matrix (and,
for the paged ones, the gather) that the CUDA kernels in ``csrc/`` avoid.
They are what those kernels are held against — on the CPU (where the
wrappers run them in place of the kernels) and on the card
(``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """f32 products and convolutions in full f32 inside the block.  On the
    card PyTorch runs f32 products in full f32 by default but f32
    convolutions through cuDNN in TF32 (about three decimal digits); this
    turns TF32 off for both and restores the flags after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) summed in full f32, output in a's dtype: the plain
    version of the matmul kernel (``csrc/matmul.cu``)."""
    with full_f32():
        return (a.float() @ b.float()).to(a.dtype)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid 2-D cross-correlation of a single-channel image, x (H, W) and
    w (kh, kw) -> (H-kh+1, W-kw+1), in full f32 (no TF32), output in x's
    dtype: the plain version of the conv2d kernel (``csrc/conv2d.cu``).
    Keeps the JAX package's (H, W) / (kh, kw) layout."""
    with full_f32():
        out = F.conv2d(x.float()[None, None], w.float()[None, None])
    return out[0, 0].to(x.dtype)


def _linearize(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(N, Hkv, bs, D) pool through (B, nb) tables -> (B, Hkv, nb*bs, D)
    where column ``t`` is absolute position ``t``."""
    B, nb = block_tables.shape
    _, Hkv, bs, D = pool.shape
    g = pool[block_tables.long()]                           # (B, nb, Hkv, bs, D)
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, nb * bs, D)


def _round(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """f32 view of ``x``, round-tripped through ``dtype`` when given."""
    if dtype is not None:
        x = x.to(dtype)
    return x.float()


def paged_attention_ref(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    read_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Single-position decode attention through block tables.

    q: (B, Hq, 1, D); k_pool/v_pool: (N, Hkv, bs, D), one layer of the
    paged pool; block_tables: (B, nb) page ids; lengths: (B,) the position
    being decoded.  Columns ``> lengths[b]`` (or outside the sliding
    window) are masked.

    ``read_dtype`` reproduces the serve gather path's two roundings (the
    decode kernel's two-phase body): K/V are read through ``read_dtype``,
    and the normalised probabilities are cast through it before the value
    product.  Returns (B, Hq, 1, D) in q's dtype.
    """
    B, Hq, S, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    if S != 1 or Hq % Hkv:
        raise ValueError(f"decode attention needs S == 1 and Hq % Hkv == 0, "
                         f"got q {tuple(q.shape)}, Hkv={Hkv}")
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    k = _round(_linearize(k_pool, block_tables), read_dtype)
    v = _round(_linearize(v_pool, block_tables), read_dtype)
    T = k.shape[2]
    qg = q.float().reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k) * scale
    col = torch.arange(T, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    mask = col <= ln
    if window is not None:
        mask &= col > ln - window
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = _round(torch.softmax(s, dim=-1), read_dtype)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v)
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def paged_prefill_attention_ref(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    base: torch.Tensor,
    *,
    chunk_len: Optional[int] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-query (chunked-prefill) attention through block tables.

    q: (B, Hq, C, D), query ``i`` of sequence ``b`` at absolute position
    ``base[b] + i``; the chunk's own K/V must already be in the pages
    (write-then-attend).  Query ``i`` attends to columns ``t <= base + i``
    (and inside the sliding window), and no column at or past
    ``base + chunk_len`` is valid — rows past ``chunk_len`` are padding
    whose output the caller discards.  Returns (B, Hq, C, D) in q's dtype.
    """
    B, Hq, C, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    if chunk_len is None:
        chunk_len = C
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    k = _linearize(k_pool, block_tables).float()
    v = _linearize(v_pool, block_tables).float()
    T = k.shape[2]
    qg = q.float().reshape(B, Hkv, group, C, D)
    s = torch.einsum("bhgcd,bhtd->bhgct", qg, k) * scale
    b0 = base.long()[:, None, None]
    col = torch.arange(T, device=q.device)[None, None, :]          # (1, 1, T)
    row = b0 + torch.arange(C, device=q.device)[None, :, None]      # (B, C, 1)
    mask = (col <= row) & (col < b0 + chunk_len)
    if window is not None:
        mask &= col > row - window
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    # a padded query past the window of every valid column has no column
    # left: its softmax is NaN, which the kernel writes as 0 — do the same
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    out = torch.einsum("bhgct,bhtd->bhgcd", p, v)
    return out.reshape(B, Hq, C, D).to(q.dtype)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    t_valid: Optional[int] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Multi-head attention with GQA, causal and sliding-window masks: the
    plain version of the flash kernel (``csrc/flash_attention.cu``).

    q: (B, Hq, S, D); k, v: (B, Hkv, T, D) with Hq % Hkv == 0.  K/V heads
    are repeated to Hq (kv head = q head // group); logits, softmax and the
    value product are f32; the output is in q's dtype.  Query row ``s``
    sits at position ``s + q_offset`` (default ``T - S``: ends aligned, as
    in decode), column ``t`` at ``t``; columns ``>= t_valid`` (default T)
    are key padding.  ``window=W`` keeps ``col > row - W``.  A row with no
    valid column gives 0, as the kernels write it (the reference's softmax
    gives NaN there; no such row occurs with ``S <= T``).
    """
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if t_valid is None:
        t_valid = T
    if q_offset is None:
        q_offset = T - S
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kx) * scale
    row = torch.arange(S, device=q.device)[:, None] + q_offset
    col = torch.arange(T, device=q.device)[None, :]
    mask = col < t_valid
    if causal:
        mask = mask & (col <= row)
    if window is not None:
        mask = mask & (col > row - window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhst,bhtd->bhsd", p, vx).to(q.dtype)
