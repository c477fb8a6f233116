"""Matmul wrapper: the CUDA kernel on the card, the plain version on the CPU.

:func:`matmul` is the counterpart of ``repro.kernels.ops.matmul`` (the
padding wrapper) around ``repro.kernels.matmul.matmul_pallas``; the kernel,
with the note on what bounds it and how it picks its tile, is in
``csrc/matmul.cu``.

The kernel predicates its m, k and n edges, so this wrapper neither pads
nor sends small shapes elsewhere: (1, 512) @ (512, 128) and 8 x 8 x 8 run
the kernel, where ``ops.matmul`` pads to its blocks and takes the oracle
below 8.  The TPU block sizes (``bm``, ``bk``, ``bn``) are tiling knobs of
the TPU and have no counterpart here.  On a CUDA tensor the wrapper checks
its arguments, launches the kernel on the current stream and counts the
launch in its ``launches`` attribute — or raises; there is no fallback.  On
a CPU tensor it runs the plain version, :func:`.ref.matmul_ref` (the CPU
tests' path), and counts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    from .build import load_library
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = load_library().repro_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, _DTYPES[a.dtype],
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
