"""Conv2d wrapper: the CUDA kernel on the card, the plain version on the CPU.

:func:`conv2d` is the counterpart of ``repro.kernels.ops.conv2d`` (the
padding wrapper) around ``repro.kernels.conv2d.conv2d_pallas``; the kernel,
with the note on what bounds it, is in ``csrc/conv2d.cu``.

The kernel predicates the image's and the output's edges, so this wrapper
neither pads rows nor sends small images elsewhere: 10 x 10 * 5 x 5 and
16 x 16 * 3 x 3 run the kernel, where ``ops.conv2d`` takes the oracle when
fewer than 8 output rows or columns remain.  The TPU's row block (``bh``)
has no counterpart here.  On a CUDA tensor the wrapper checks its
arguments, launches the kernel on the current stream and counts the launch
in its ``launches`` attribute — or raises; there is no fallback.  On a CPU
tensor it runs the plain version, :func:`.ref.conv2d_ref` (the CPU tests'
path), and counts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref

# the largest kh and kw of csrc/conv2d.cu (repro_conv2d_max_taps)
MAX_TAPS = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} unsupported (float32, bfloat16)")
    if w.dtype != x.dtype:
        raise TypeError(f"w dtype {w.dtype} differs from x's {x.dtype}")
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must be "
                         f"(H, W) and (kh, kw)")
    (h, wd), (kh, kw) = x.shape, w.shape
    if not (1 <= kh <= MAX_TAPS and 1 <= kw <= MAX_TAPS):
        raise ValueError(f"taps {kh} x {kw} outside [1, {MAX_TAPS}]")
    if h < kh or wd < kw:
        raise ValueError(f"image {h} x {wd} smaller than the taps {kh} x {kw}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous (row-major)")


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation, x (H, W) * w (kh, kw) -> (H-kh+1, W-kw+1),
    both float32 or both bfloat16 on one device, kh and kw up to
    ``MAX_TAPS``.  f32 sums inside, rounded once to x's dtype."""
    _check(x, w)
    if x.device.type == "cpu":
        return ref.conv2d_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d: unsupported device {x.device}")
    from .build import load_library
    (h, wd), (kh, kw) = x.shape, w.shape
    out = torch.empty((h - kh + 1, wd - kw + 1), dtype=x.dtype, device=x.device)
    err = load_library().repro_conv2d(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), h, wd, kh, kw, _DTYPES[x.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err:
        raise RuntimeError(f"conv2d kernel launch failed: CUDA error {err}")
    conv2d.launches += 1
    return out


conv2d.launches = 0


def prepare(device: torch.device) -> None:
    """Build and load the kernel library, check its largest tap count, then
    launch the kernel once on a 16 x 16 f32 image with 3 x 3 taps and
    synchronise — so a caller's first timed call pays no build or module
    load, and a card that cannot launch the kernel raises here.  The launch
    is counted like any other."""
    from .build import load_library
    built = load_library().repro_conv2d_max_taps()
    if built != MAX_TAPS:
        raise RuntimeError(f"library takes taps up to {built}, the wrapper "
                           f"{MAX_TAPS}")
    x = torch.zeros((16, 16), dtype=torch.float32, device=device)
    conv2d(x, x[:3, :3].contiguous())
    torch.cuda.synchronize(device)


def reset_launch_counts() -> None:
    conv2d.launches = 0
