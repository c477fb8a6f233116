"""Flash attention wrappers: the CUDA kernels on the card, the plain
versions on the CPU.

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

:func:`flash_attention_bwd_cuda` is the backward kernel's wrapper (bf16;
``csrc/flash_attention_bwd.cu``), with no counterpart in the JAX package:
it takes the forward's output and log-sum-exp (``with_lse=True``) and
pads as the forward does; its plain version is
:func:`.ref.flash_attention_bwd_ref`.
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
# tiles of csrc/flash_attention_bwd.cu (repro_flash_bwd_block_q/_k, bf16
# only) and the head dims of its instantiations (repro_flash_bwd_head_tile)
BWD_BLOCK_Q, BWD_BLOCK_K = 128, 64
BWD_HEAD_TILES = (64, 128)


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
    with_lse: bool = False,
):
    """Forward attention, q: (B, Hq, S, D), k/v: (B, Hkv, T, D), all of one
    dtype (float32 or bfloat16) on one device, ``D <= 128``.  Query row
    ``s`` attends as position ``s + T - S``.  Returns (B, Hq, S, D) in q's
    dtype; f32 scores, softmax and accumulator inside.  ``with_lse``
    (bfloat16 only) returns ``(out, lse)``, where lse (B, Hq, S') f32 is
    each row's log-sum-exp over S' = S padded to :data:`BLOCK_Q`: what
    :func:`flash_attention_bwd_cuda` takes.  The output is the same bit for
    bit with or without it."""
    _check(q, k, v)
    if with_lse and q.dtype != torch.bfloat16:
        raise TypeError(f"with_lse needs bfloat16, got {q.dtype}")
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    sp, tp = _round_up(S, BLOCK_Q[q.dtype]), _round_up(T, BLOCK_K[q.dtype])
    dp = _round_up(D, DIM_MULTIPLE[q.dtype])
    qp, kp, vp = _pad(q, sp, dp), _pad(k, tp, dp), _pad(v, tp, dp)
    opts = dict(causal=causal, window=window, scale=scale, t_valid=T, q_offset=T - S)
    if q.device.type in PLAIN_DEVICES:
        out = ref.attention_ref(qp, kp, vp, **opts)[:, :, :S, :D]
        return (out, ref.attention_lse_ref(qp, kp, **opts)) if with_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: unsupported device {q.device}")
    from .build import load_library
    out = torch.empty_like(qp)
    lse = torch.empty((B, Hq, sp), dtype=torch.float32, device=q.device) if with_lse else None
    err = load_library().repro_flash_attention(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Hq, Hkv, sp, tp, dp, T, T - S, int(causal),
        -1 if window is None else int(window), float(scale), _DTYPES[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    out = out[:, :, :S, :D]
    return (out, lse) if with_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(
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
) -> tuple:
    """The gradients (dq, dk, dv) of :func:`flash_attention_cuda` at q, k, v
    for the output's gradient ``g``: q, o, g (B, Hq, S, D) and k, v (B,
    Hkv, T, D) in bfloat16, o and lse the forward's output and log-sum-exp
    (``with_lse``).  The same padding as the forward (S to
    :data:`BWD_BLOCK_Q` rows, T to :data:`BWD_BLOCK_K` keys, D to a
    multiple of 8, all zeros, so padded rows and keys add nothing), and the
    kernel's instantiation is the smallest of :data:`BWD_HEAD_TILES` that
    holds the padded D.  On a CUDA tensor it launches the backward kernels
    (``csrc/flash_attention_bwd.cu``) and counts one call in ``launches``
    — or raises; there is no fallback.  On a CPU tensor it runs the same
    padding around the plain version, :func:`.ref.flash_attention_bwd_ref`,
    and counts nothing."""
    _check(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the backward kernel takes bfloat16, got {q.dtype}")
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    for n, t in (("o", o), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{n} {tuple(t.shape)} {t.dtype} on {t.device} does not "
                             f"match q {tuple(q.shape)} {q.dtype} on {q.device}")
    sp, tp = _round_up(S, BWD_BLOCK_Q), _round_up(T, BWD_BLOCK_K)
    dp = _round_up(D, DIM_MULTIPLE[q.dtype])
    if lse.shape != (B, Hq, sp) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} on {lse.device} is not "
                         f"({B}, {Hq}, {sp}) float32 on {q.device}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qp, op, gp = _pad(q, sp, dp), _pad(o, sp, dp), _pad(g, sp, dp)
    kp, vp = _pad(k, tp, dp), _pad(v, tp, dp)
    if q.device.type in PLAIN_DEVICES:
        dq, dk, dv = ref.flash_attention_bwd_ref(
            qp, kp, vp, op, lse, gp, causal=causal, window=window, scale=scale,
            t_valid=T, q_offset=T - S)
    elif q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda: unsupported device {q.device}")
    else:
        from .build import load_library
        tile = next(i for i, dims in enumerate(BWD_HEAD_TILES) if dp <= dims)
        dq, dk, dv = torch.empty_like(qp), torch.empty_like(kp), torch.empty_like(vp)
        delta = torch.empty((B, Hq, sp), dtype=torch.float32, device=q.device)
        err = load_library().repro_flash_attention_bwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), op.data_ptr(),
            lse.contiguous().data_ptr(), gp.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, Hq, Hkv, sp, tp, dp, T, T - S,
            int(causal), -1 if window is None else int(window), float(scale), tile,
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
        if err:
            raise RuntimeError(f"flash attention backward launch failed: CUDA error {err}")
        flash_attention_bwd_cuda.launches += 1
    return dq[:, :, :S, :D], dk[:, :, :T, :D], dv[:, :, :T, :D]


flash_attention_bwd_cuda.launches = 0


def prepare(dtype: torch.dtype, num_heads: int, num_kv_heads: int,
            head_dim: int, device: torch.device) -> None:
    """Build and load the kernel library, then launch the kernel once at
    the model's head shape (one q tile of the dtype; in bf16 the backward
    too) and synchronise — so a caller's first timed step pays no build or
    module load, and a card that cannot launch the kernels at this shape
    raises here.  The launches are counted like any other."""
    from .build import load_library
    lib = load_library()
    for dt, code in _DTYPES.items():
        built = (lib.repro_flash_block_q(code), lib.repro_flash_block_k(code),
                 lib.repro_flash_max_head_dim())
        want = (BLOCK_Q[dt], BLOCK_K[dt], MAX_HEAD_DIM)
        if built != want:
            raise RuntimeError(f"library tiles {built} for {dt} differ from the "
                               f"wrapper's {want}")
    built = (lib.repro_flash_bwd_block_q(), lib.repro_flash_bwd_block_k(),
             tuple(lib.repro_flash_bwd_head_tile(i) for i in range(len(BWD_HEAD_TILES))))
    if built != (BWD_BLOCK_Q, BWD_BLOCK_K, BWD_HEAD_TILES):
        raise RuntimeError(f"library backward tiles {built} differ from the wrapper's "
                           f"{(BWD_BLOCK_Q, BWD_BLOCK_K, BWD_HEAD_TILES)}")
    q = torch.zeros((1, num_heads, BLOCK_Q[dtype], head_dim), dtype=dtype,
                    device=device)
    kv = torch.zeros((1, num_kv_heads, BLOCK_K[dtype], head_dim), dtype=dtype,
                     device=device)
    if dtype == torch.bfloat16:
        out, lse = flash_attention_cuda(q, kv, kv, with_lse=True)
        flash_attention_bwd_cuda(q, kv, kv, out, lse, q)
    else:
        flash_attention_cuda(q, kv, kv)
    torch.cuda.synchronize(device)


def reset_launch_counts() -> None:
    flash_attention_cuda.launches = 0
    flash_attention_bwd_cuda.launches = 0
