"""Plain PyTorch versions of the kernels.

The counterparts of ``repro.kernels.ref``: ``matmul_ref`` and
``conv2d_ref``, and ``attention_ref``, ``paged_attention_ref`` and
``paged_prefill_attention_ref``, which materialise the score matrix (and,
for the paged ones, the gather) that the CUDA kernels in ``csrc/`` avoid;
and, with no counterpart there (the JAX package has no backward kernel),
``attention_lse_ref`` and ``flash_attention_bwd_ref``, the flash forward's
saved log-sum-exp and the backward kernel's algorithm.
They are what those kernels are held against — on the CPU (where the
wrappers run them in place of the kernels) and on the card
(``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

# the devices on which a kernel wrapper runs its plain version: the CPU
# (the CPU tests) and the meta device (the dry run, which allocates and
# launches nothing); a CUDA tensor launches the kernel or raises
PLAIN_DEVICES = ("cpu", "meta")


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
    vx = v.repeat_interleave(group, dim=1).float()
    s = _masked_scores(q, k, causal, window, scale, t_valid, q_offset)
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhst,bhtd->bhsd", p, vx).to(q.dtype)


def _kept(rows: torch.Tensor, cols: torch.Tensor, causal: bool, window: Optional[int],
          t_valid: int) -> torch.Tensor:
    """(len(rows), len(cols)) mask of the pairs attention keeps: query
    positions ``rows`` against key positions ``cols``."""
    row, col = rows[:, None], cols[None, :]
    mask = col < t_valid
    if causal:
        mask = mask & (col <= row)
    if window is not None:
        mask = mask & (col > row - window)
    return mask


def _masked_scores(q, k, causal, window, scale, t_valid, q_offset) -> torch.Tensor:
    """f32 scores q k^T * scale (B, Hq, S, T), grouped K heads repeated to
    Hq, with the pairs attention drops at -inf; the defaults of
    :func:`attention_ref`."""
    S, T = q.shape[2], k.shape[2]
    if t_valid is None:
        t_valid = T
    if q_offset is None:
        q_offset = T - S
    kx = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kx) * scale
    mask = _kept(torch.arange(S, device=q.device) + q_offset,
                 torch.arange(T, device=q.device), causal, window, t_valid)
    return s.masked_fill(~mask, float("-inf"))


def attention_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    t_valid: Optional[int] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """The log-sum-exp of each row's kept f32 scores (``q k^T * scale``),
    (B, Hq, S) f32, with :func:`attention_ref`'s arguments: what the flash
    kernel's bf16 body saves for the backward.  A row with no valid column
    gives -inf."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _masked_scores(q, k, causal, window, scale, t_valid, q_offset)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    t_valid: Optional[int] = None,
    q_offset: Optional[int] = None,
    block_q: int = 64,
    block_k: int = 64,
) -> tuple:
    """The gradients (dq, dk, dv) of attention, computed as the flash
    backward kernel (``csrc/flash_attention_bwd.cu``) computes them: the
    plain version it is held against.

    q, o, g (the output's gradient): (B, Hq, S, D); k, v: (B, Hkv, T, D);
    lse: (B, Hq, S) f32, the forward's :func:`attention_lse_ref`; the
    other arguments as :func:`attention_ref`'s.  Tile by tile of
    ``block_q`` rows and ``block_k`` keys, skipping tiles the mask drops
    whole: P = exp(S * scale - lse) in f32 (0 where masked), dP = g V^T,
    dS = P (dP - D) with D = rowsum(g o) in f32; P is rounded to bf16
    before dV += P^T g, and dS before dK += dS^T q and dQ += dS K, each
    product summed in f32; dq and dk take the scale at the end.  Grouped
    query heads sum into their K/V head's dk, dv.  Returns q's, k's and
    v's dtypes.
    """
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if t_valid is None:
        t_valid = T
    if q_offset is None:
        q_offset = T - S
    log2e = 1.4426950408889634
    qf = q.float().reshape(B, Hkv, G, S, D)
    gf = g.float().reshape(B, Hkv, G, S, D)
    kf, vf = k.float(), v.float()
    lse2 = (lse.float() * log2e).reshape(B, Hkv, G, S, 1)
    delta = (gf * o.float().reshape(B, Hkv, G, S, D)).sum(-1, keepdim=True)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    positions = torch.arange(max(S, T), device=q.device)
    for c0 in range(0, T, block_k):
        c1 = min(c0 + block_k, T)
        for r0 in range(0, S, block_q):
            r1 = min(r0 + block_q, S)
            ok = _kept(positions[r0:r1] + q_offset, positions[c0:c1], causal, window,
                       t_valid)
            if not ok.any():
                continue
            qi, gi = qf[:, :, :, r0:r1], gf[:, :, :, r0:r1]
            kj, vj = kf[:, :, c0:c1], vf[:, :, c0:c1]
            s = torch.einsum("bhgsd,bhtd->bhgst", qi, kj)
            p = torch.where(ok, torch.exp2(s * (scale * log2e) - lse2[:, :, :, r0:r1]), 0.0)
            dp = torch.einsum("bhgsd,bhtd->bhgst", gi, vj)
            ds = p * (dp - delta[:, :, :, r0:r1])
            p, ds = _round(p, torch.bfloat16), _round(ds, torch.bfloat16)
            dv[:, :, c0:c1] += torch.einsum("bhgst,bhgsd->bhtd", p, gi)
            dk[:, :, c0:c1] += torch.einsum("bhgst,bhgsd->bhtd", ds, qi)
            dq[:, :, :, r0:r1] += torch.einsum("bhgst,bhtd->bhgsd", ds, kj)
    return ((dq * scale).reshape(B, Hq, S, D).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))
