"""Paged attention wrappers: the CUDA kernels on the card, the plain
versions on the CPU.

:func:`paged_attention_cuda` (single-query decode) and
:func:`paged_prefill_attention_cuda` (multi-query chunked prefill) are the
counterparts of ``repro.kernels.paged_attention.paged_attention_pallas``
and ``paged_prefill_attention_pallas``; the kernels themselves, with the
note on what bounds them, are in ``csrc/paged_attention.cu``.

On a CUDA tensor a wrapper checks its arguments, allocates the output,
launches the kernel on the current stream and counts the launch in its
``launches`` attribute — or raises; there is no fallback.  On a CPU tensor
(and on the dry run's meta tensors, :data:`.ref.PLAIN_DEVICES`) it returns
the plain version from :mod:`.ref` (the CPU tests' path) and counts
nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import ref
from .ref import PLAIN_DEVICES

# largest dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 prefill body (wgmma tiles of 128 dims, 16-byte cp.async rows)
# takes head dims up to this, padded to a multiple of PREFILL_DIM_MULTIPLE
PREFILL_MAX_HEAD_DIM = 128
PREFILL_DIM_MULTIPLE = 8
# decode: head dims up to this (two 128-dim passes of a warp's lanes),
# padded to whole 16-byte rows (4 f32 or 8 bf16 elements)
DECODE_MAX_HEAD_DIM = 256
# decode split plan: keys per split (rounded up to whole pages), and the
# blocks per SM that the splits of all heads may reach at most
DECODE_SPLIT_KEYS = 64
DECODE_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def decode_split_plan(B: int, Hkv: int, nb: int, bs: int, sms: int) -> tuple:
    """(splits, keys per split) of the decode kernel's grid (splits, Hkv, B)
    over a table of ``nb`` pages of ``bs`` keys, on a card with ``sms``
    SMs.  From shapes alone: the lengths stay on the device.

    A split is ``DECODE_SPLIT_KEYS`` keys rounded up to whole pages, so
    that at small batch the grid puts many blocks per SM in flight; where
    that would give more than ``DECODE_BLOCKS_PER_SM`` blocks per SM over
    all B * Hkv heads, the splits grow (whole pages again) until it does
    not; and where B * Hkv alone gives every SM two blocks, one split
    covers the whole table.  splits * keys always covers nb * bs keys."""
    total = nb * bs
    heads = B * Hkv
    if heads >= 2 * sms:
        return 1, total
    kps = bs * -(-DECODE_SPLIT_KEYS // bs)
    most = max(1, -(-DECODE_BLOCKS_PER_SM * sms // heads))
    if -(-total // kps) > most:
        kps = bs * -(-(-(-total // most)) // bs)
    return -(-total // kps), kps


def decode_workspace_floats(B: int, Hkv: int, G: int, D: int, splits: int) -> int:
    """f32 elements of the decode workspace: per (b, h, split, g) the
    split's (m, l) and its D partial sums."""
    return B * Hkv * splits * G * (2 + D)


def _lib():
    from .build import load_library
    return load_library()


def _device(name: str, q: torch.Tensor, k_pool: torch.Tensor,
            v_pool: torch.Tensor, block_tables: torch.Tensor,
            per_seq: torch.Tensor) -> torch.device:
    """The one device every argument lies on (the wrapper dispatches on
    it); raises if they differ."""
    tensors = {"k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, name: per_seq}
    for n, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{n} is on {t.device}, q on {q.device}")
    return q.device


def _check(name: str, q: torch.Tensor, k_pool: torch.Tensor,
           v_pool: torch.Tensor, block_tables: torch.Tensor,
           per_seq: torch.Tensor) -> None:
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, name: per_seq}
    for n, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} unsupported (float32, bfloat16)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools ({k_pool.dtype}, {v_pool.dtype}) must have "
                        f"q's dtype {q.dtype}")
    if block_tables.dtype != torch.int32 or per_seq.dtype != torch.int32:
        raise TypeError(f"block_tables and {name} must be int32")
    if q.ndim != 4 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, Hq, S, D) and the "
                         f"pools (N, Hkv, bs, D) alike, got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    B, Hq, _, D = q.shape
    _, Hkv, _, Dk = k_pool.shape
    if Dk != D or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool "
                         f"{tuple(k_pool.shape)} (head_dim, Hq % Hkv)")
    if block_tables.ndim != 2 or block_tables.shape[0] != B \
            or tuple(per_seq.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} and "
                         f"{name} {tuple(per_seq.shape)} must be (B, nb), (B,)")


@functools.lru_cache(maxsize=None)
def _decode_smem(D: int, bs: int, kps: int, dtype: int) -> int:
    return _lib().repro_paged_decode_smem(D, bs, kps, dtype)


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def paged_attention_cuda(
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
    """Decode attention over one layer of the paged pool.

    q: (B, Hq, 1, D); k_pool/v_pool: (N, Hkv, bs, D) in q's dtype;
    block_tables: (B, nb) int32 page ids; lengths: (B,) int32, the position
    being decoded (columns ``<= lengths[b]`` are valid, inside ``window``
    when set).  ``read_dtype=torch.bfloat16`` selects the two-phase body
    that reproduces the gather path's bf16 roundings.  Page ids must lie
    in ``[0, N)``: the kernel does not bounds-check them.  Returns
    (B, Hq, 1, D).

    One call is one launch in ``launches`` and, on the card, 2 kernel
    launches (plain body: split pass, combine) or 3 (``read_dtype``:
    stats pass, value pass, combine) over :func:`decode_split_plan`'s
    grid, with an f32 workspace allocated here.  A head dim that does not
    fill whole 16-byte rows (4 f32, 8 bf16 elements) is zero-padded (q
    and both pools are copied, so no configured model takes that path),
    and head dims above ``DECODE_MAX_HEAD_DIM`` raise.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    device = _device("lengths", q, k_pool, v_pool, block_tables, lengths)
    if device.type in PLAIN_DEVICES:
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                                       window=window, scale=scale,
                                       read_dtype=read_dtype)
    if device.type != "cuda":
        raise ValueError(f"paged_attention_cuda: unsupported device {device}")
    _check("lengths", q, k_pool, v_pool, block_tables, lengths)
    if q.shape[2] != 1:
        raise ValueError(f"decode attention is single-position, q {tuple(q.shape)}")
    if read_dtype not in (None, torch.bfloat16):
        raise TypeError(f"read_dtype must be None or bfloat16, got {read_dtype}")
    B, Hq, _, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    if D > DECODE_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {DECODE_MAX_HEAD_DIM} (decode)")
    pad = -D % (16 // q.element_size())
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool))
    if pad or not aligned:
        # whole 16-byte rows for the kernel's copies; zeros score and sum
        # nothing, and the scale stays the real D's
        q, k_pool, v_pool = (F.pad(t, (0, pad)) if pad else t.clone()
                             for t in (q, k_pool, v_pool))
        out = paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths,
                                   window=window, scale=scale, read_dtype=read_dtype)
        return out[..., :D].contiguous()
    G = Hq // Hkv
    nb = block_tables.shape[1]
    from .build import sm_count
    lib = _lib()
    splits, kps = decode_split_plan(B, Hkv, nb, bs, sm_count(q.device))
    dtype = _DTYPES[q.dtype]
    smem = _decode_smem(D, bs, kps, dtype)
    if smem > MAX_SMEM:
        raise ValueError(f"decode block needs {smem} B of shared memory "
                         f"(D={D}, bs={bs}, {kps} keys per split); the "
                         f"limit is {MAX_SMEM}")
    out = torch.empty_like(q)
    workspace = torch.empty(decode_workspace_floats(B, Hkv, G, D, splits),
                            dtype=torch.float32, device=q.device)
    err = lib.repro_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        workspace.data_ptr(), B, Hkv, G, D, bs, nb, splits, kps,
        -1 if window is None else int(window), float(scale), dtype,
        int(read_dtype is not None), q.device.index, _stream(q.device))
    if err:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_prefill_attention_cuda(
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
    """Chunked-prefill attention over one layer of the paged pool.

    q: (B, Hq, C, D), query ``i`` of sequence ``b`` at absolute position
    ``base[b] + i``, with the chunk's own K/V already in its pages;
    block_tables: (B, nb) int32; base: (B,) int32.  ``chunk_len`` (a host
    int, default C) caps valid columns at ``base + chunk_len``; it is a
    kernel argument, so a new chunk length builds nothing.  Returns
    (B, Hq, C, D); rows past ``chunk_len`` are padding.  In bf16 the head
    dim must be at most 128; one that is not a multiple of 8 is zero-padded
    (q and both pools are copied, so no configured model takes that path)
    and the output sliced.
    """
    if chunk_len is None:
        chunk_len = q.shape[2]
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    device = _device("base", q, k_pool, v_pool, block_tables, base)
    if device.type in PLAIN_DEVICES:
        return ref.paged_prefill_attention_ref(
            q, k_pool, v_pool, block_tables, base, chunk_len=chunk_len,
            window=window, scale=scale)
    if device.type != "cuda":
        raise ValueError(
            f"paged_prefill_attention_cuda: unsupported device {device}")
    _check("base", q, k_pool, v_pool, block_tables, base)
    B, Hq, C, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    if not 1 <= int(chunk_len) <= C:
        raise ValueError(f"chunk_len={chunk_len} outside [1, C={C}]")
    if q.dtype == torch.bfloat16:
        if D > PREFILL_MAX_HEAD_DIM:
            raise ValueError(f"head_dim {D} > {PREFILL_MAX_HEAD_DIM} (bf16 prefill)")
        pad = -D % PREFILL_DIM_MULTIPLE
        aligned = all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool))
        if pad or not aligned:
            q, k_pool, v_pool = (F.pad(t, (0, pad)) if pad else t.clone()
                                 for t in (q, k_pool, v_pool))
            out = paged_prefill_attention_cuda(
                q, k_pool, v_pool, block_tables, base, chunk_len=chunk_len,
                window=window, scale=scale)
            return out[..., :D].contiguous()
    lib = _lib()
    smem = lib.repro_paged_prefill_smem(D, bs, _DTYPES[q.dtype])
    if smem > MAX_SMEM:
        raise ValueError(f"prefill tile needs {smem} B of shared memory "
                         f"(D={D}, bs={bs}); the limit is {MAX_SMEM}")
    out = torch.empty_like(q)
    err = lib.repro_paged_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), base.data_ptr(), int(chunk_len),
        out.data_ptr(), B, Hkv, Hq // Hkv, C, D, bs, block_tables.shape[1],
        -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], _stream(q.device))
    if err:
        raise RuntimeError(f"paged prefill kernel launch failed: CUDA error {err}")
    paged_prefill_attention_cuda.launches += 1
    return out


paged_prefill_attention_cuda.launches = 0


def prepare(dtype: torch.dtype, num_heads: int, num_kv_heads: int,
            head_dim: int, block_size: int, device: torch.device) -> None:
    """Build and load the kernels, then launch each once on a one-page
    pool at the model's head shape and synchronise — decode in both bodies
    (its split, stats, value and combine kernels), then prefill — so a
    caller's first timed call pays no build or module load, and a kernel
    that cannot launch at this shape raises here.  These launches are
    counted like any other."""
    q = torch.zeros((1, num_heads, 1, head_dim), dtype=dtype, device=device)
    pool = torch.zeros((1, num_kv_heads, block_size, head_dim), dtype=dtype,
                       device=device)
    table = torch.zeros((1, 1), dtype=torch.int32, device=device)
    zero = torch.zeros((1,), dtype=torch.int32, device=device)
    paged_attention_cuda(q, pool, pool, table, zero)
    paged_attention_cuda(q, pool, pool, table, zero, read_dtype=torch.bfloat16)
    paged_prefill_attention_cuda(q, pool, pool, table, zero)
    torch.cuda.synchronize(device)


def reset_launch_counts() -> None:
    paged_attention_cuda.launches = 0
    paged_prefill_attention_cuda.launches = 0
