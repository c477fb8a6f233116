"""Flash attention wrapper: the CUDA kernel on the card, the plain version
on the CPU.

:func:`flash_attention_cuda` is the counterpart of
``repro.kernels.ops.flash_attention`` (the padding wrapper) around
``repro.kernels.flash_attention.flash_attention_pallas``; the kernel,
with the note on what bounds it, is in ``csrc/flash_attention.cu``.

The wrapper pads S and T up to the kernel's tiles for the dtype (f32:
64-row q tiles; bf16: 128-row q tiles, two warpgroups of 64; both 64-key
k tiles) and passes ``t_valid=T`` and ``q_offset=T-S``, as
``ops.flash_attention`` does, so padded keys stay inert and the rows keep
their end alignment.  In bf16 it also zero-pads a head dim that is not a
multiple of 8 (a TMA row must be a multiple of 16 bytes) and slices the
output; the scale stays the one of the real head dim, and zero dims add
nothing to a score.  On a CUDA tensor it checks its arguments, launches
the kernel on the current stream and counts the launch in its
``launches`` attribute — or raises; there is no fallback.  On a CPU
tensor (and on the dry run's meta tensors, :data:`.ref.PLAIN_DEVICES`)
it runs the same padding around the plain version,
:func:`.ref.attention_ref` (the CPU tests' path), and counts nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import ref
from .ref import PLAIN_DEVICES

# tile sizes of csrc/flash_attention.cu per dtype (repro_flash_block_q/_k):
# the padded S and T are multiples of them; the kernel refuses other shapes
BLOCK_Q = {torch.float32: 64, torch.bfloat16: 128}
BLOCK_K = {torch.float32: 64, torch.bfloat16: 64}
MAX_HEAD_DIM = 128
# the bf16 body loads rows by TMA: the head dim is padded to a multiple of
# this, and the tensors start on 16-byte boundaries
DIM_MULTIPLE = {torch.float32: 1, torch.bfloat16: 8}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad(x: torch.Tensor, rows: int, dims: int) -> torch.Tensor:
    """``x`` (B, H, n, D) zero-padded to ``rows`` rows and ``dims`` dims,
    contiguous and starting on a 16-byte boundary."""
    pad_d, pad_r = dims - x.shape[3], rows - x.shape[2]
    x = (F.pad(x, (0, pad_d, 0, pad_r)) if pad_d or pad_r else x).contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for n, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{n} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{n} dtype {t.dtype} differs from q's {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} unsupported (float32, bfloat16)")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, Hq, S, D) and k/v "
                         f"(B, Hkv, T, D) alike, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    B, Hq, S, D = q.shape
    Bk, Hkv, T, Dk = k.shape
    if Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (batch, head_dim, Hq % Hkv)")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} outside [1, {MAX_HEAD_DIM}]")
    if S < 1 or T < 1:
        raise ValueError(f"empty attention: S={S}, T={T}")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Forward attention, q: (B, Hq, S, D), k/v: (B, Hkv, T, D), all of one
    dtype (float32 or bfloat16) on one device, ``D <= 128``.  Query row
    ``s`` attends as position ``s + T - S``.  Returns (B, Hq, S, D) in q's
    dtype; f32 scores, softmax and accumulator inside."""
    _check(q, k, v)
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    sp, tp = _round_up(S, BLOCK_Q[q.dtype]), _round_up(T, BLOCK_K[q.dtype])
    dp = _round_up(D, DIM_MULTIPLE[q.dtype])
    qp, kp, vp = _pad(q, sp, dp), _pad(k, tp, dp), _pad(v, tp, dp)
    if q.device.type in PLAIN_DEVICES:
        out = ref.attention_ref(qp, kp, vp, causal=causal, window=window,
                                scale=scale, t_valid=T, q_offset=T - S)
        return out[:, :, :S, :D]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: unsupported device {q.device}")
    from .build import load_library
    out = torch.empty_like(qp)
    err = load_library().repro_flash_attention(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, sp, tp, dp, T, T - S, int(causal),
        -1 if window is None else int(window), float(scale), _DTYPES[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out[:, :, :S, :D]


flash_attention_cuda.launches = 0


def prepare(dtype: torch.dtype, num_heads: int, num_kv_heads: int,
            head_dim: int, device: torch.device) -> None:
    """Build and load the kernel library, then launch the kernel once at
    the model's head shape (one q tile of the dtype) and synchronise — so
    a caller's first timed step pays no build or module load, and a card
    that cannot launch the kernel at this shape raises here.  The launch
    is counted like any other."""
    from .build import load_library
    lib = load_library()
    for dt, code in _DTYPES.items():
        built = (lib.repro_flash_block_q(code), lib.repro_flash_block_k(code),
                 lib.repro_flash_max_head_dim())
        want = (BLOCK_Q[dt], BLOCK_K[dt], MAX_HEAD_DIM)
        if built != want:
            raise RuntimeError(f"library tiles {built} for {dt} differ from the "
                               f"wrapper's {want}")
    q = torch.zeros((1, num_heads, BLOCK_Q[dtype], head_dim), dtype=dtype,
                    device=device)
    kv = torch.zeros((1, num_kv_heads, BLOCK_K[dtype], head_dim), dtype=dtype,
                     device=device)
    flash_attention_cuda(q, kv, kv)
    torch.cuda.synchronize(device)


def reset_launch_counts() -> None:
    flash_attention_cuda.launches = 0
