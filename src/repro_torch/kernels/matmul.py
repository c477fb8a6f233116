"""Matmul wrapper: the CUDA kernel on the card, the plain version on the CPU.

:func:`matmul` is the counterpart of ``repro.kernels.ops.matmul`` (the
padding wrapper) around ``repro.kernels.matmul.matmul_pallas``; the kernel,
with the note on what bounds it and how it picks its tile, is in
``csrc/matmul.cu``.

The kernel predicates its m, k and n edges, so this wrapper neither pads
nor sends small shapes elsewhere: (1, 512) @ (512, 128) and 8 x 8 x 8 run
the kernel, where ``ops.matmul`` pads to its blocks and takes the oracle
below 8.  The TPU block sizes (``bm``, ``bk``, ``bn``) are tiling knobs of
the TPU and have no counterpart here; the kernel's own output tile is
chosen by :func:`matmul_tile` and passed down.  On a CUDA tensor the
wrapper checks its arguments, launches the kernel on the current stream
and counts the launch in its ``launches`` attribute — or raises; there is
no fallback.  On a CPU tensor it runs the plain version,
:func:`.ref.matmul_ref` (the CPU tests' path), and counts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's output tiles, by the index it takes: (rows, columns, threads)
MATMUL_TILES = ((64, 32, 128), (128, 128, 256))


def matmul_tile(m: int, n: int, sms: int) -> int:
    """Index into :data:`MATMUL_TILES` of the tile for an (m, n) output on a
    card with ``sms`` SMs: 128 x 128 where such tiles give every SM a block
    (2048^2 and up on an H100), else 64 x 32, which gives the paper path's
    512^2 128 blocks of 4 warps."""
    big_rows, big_cols, _ = MATMUL_TILES[1]
    big_blocks = -(-m // big_rows) * -(-n // big_cols)
    return 1 if big_blocks >= sms else 0


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"dtype {a.dtype} unsupported (float32, bfloat16)")
    if b.dtype != a.dtype:
        raise TypeError(f"b dtype {b.dtype} differs from a's {a.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         f"(m, k) and (k, n)")
    if 0 in a.shape or 0 in b.shape:
        raise ValueError(f"empty product: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous (row-major)")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b (k, n), both float32 or both bfloat16, row-major, on one
    device.  Returns (m, n) in a's dtype: f32 sums inside, rounded once."""
    _check(a, b)
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {a.device}")
    from .build import load_library, sm_count
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    tile = matmul_tile(m, n, sm_count(a.device))
    err = load_library().repro_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, tile, _DTYPES[a.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream))
    if err:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    matmul.launches += 1
    return out


matmul.launches = 0


def prepare(device: torch.device) -> None:
    """Build and load the kernel library, then launch the kernel once on an
    8 x 8 x 8 f32 product and synchronise — so a caller's first timed call
    pays no build or module load, and a card that cannot launch the kernel
    raises here.  The launch is counted like any other."""
    a = torch.zeros((8, 8), dtype=torch.float32, device=device)
    matmul(a, a)
    torch.cuda.synchronize(device)


def reset_launch_counts() -> None:
    matmul.launches = 0
