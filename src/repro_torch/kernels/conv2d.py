"""Conv2d wrapper: the CUDA kernel on the card, the plain version on the CPU.

:func:`conv2d` is the counterpart of ``repro.kernels.ops.conv2d`` (the
padding wrapper) around ``repro.kernels.conv2d.conv2d_pallas``; the kernel,
with the note on what bounds it, is in ``csrc/conv2d.cu``.

The kernel zero-fills past the image's edges and predicates the output's,
so this wrapper neither pads rows nor sends small images elsewhere: 10 x 10
* 5 x 5 and 16 x 16 * 3 x 3 run the kernel, where ``ops.conv2d`` takes the
oracle when fewer than 8 output rows or columns remain.  The TPU's row
block (``bh``) has no counterpart here; the kernel's instantiation (taps
fixed at compile time or not) and its output tile are chosen by
:func:`conv2d_plan` and passed down.  On a CUDA tensor the wrapper checks
its arguments, launches the kernel on the current stream and counts the
launch in its ``launches`` attribute — or raises; there is no fallback.  On
a CPU tensor it runs the plain version, :func:`.ref.conv2d_ref` (the CPU
tests' path), and counts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref

# the largest kh and kw of csrc/conv2d.cu (repro_conv2d_max_taps)
MAX_TAPS = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's instantiations, by the index it takes: the taps fixed at
# compile time, None for the runtime-size one
CONV_TAPS = (None, (3, 3), (5, 5))
# the kernel's output tiles, by the index it takes: (columns, rows, threads)
CONV_TILES = ((32, 32, 128), (64, 64, 256))
# every (dtype, taps, tile) the library holds: what prepare launches
INSTANTIATIONS = tuple((dtype, taps, tile) for dtype in _DTYPES
                       for taps in range(len(CONV_TAPS)) for tile in range(len(CONV_TILES)))


def conv2d_plan(h: int, wd: int, kh: int, kw: int, sms: int) -> tuple:
    """(taps, tile), indices into :data:`CONV_TAPS` and :data:`CONV_TILES`,
    for an (h, wd) image and (kh, kw) taps on a card with ``sms`` SMs: the
    instantiation fixed at the taps' size where there is one (the image
    pipeline's 3 x 3, Table 1's 5 x 5), else the runtime-size one; 64 x 64
    tiles where such tiles give every SM a block (outputs from 705^2 on an
    H100; 4096^2 * 5 x 5 gets 4096 blocks), else 32 x 32, which gives the
    paths' 508^2 and 382^2 outputs 256 and 144 blocks."""
    taps = CONV_TAPS.index((kh, kw)) if (kh, kw) in CONV_TAPS else 0
    cols, rows, _ = CONV_TILES[1]
    big_blocks = -(-(wd - kw + 1) // cols) * -(-(h - kh + 1) // rows)
    return taps, 1 if big_blocks >= sms else 0


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
    from .build import sm_count
    return launch(x, w, *conv2d_plan(*x.shape, *w.shape, sm_count(x.device)))


conv2d.launches = 0


def launch(x: torch.Tensor, w: torch.Tensor, taps: int, tile: int) -> torch.Tensor:
    """:func:`conv2d` on CUDA tensors with the instantiation and the tile
    given (indices into :data:`CONV_TAPS` and :data:`CONV_TILES`), where
    :func:`conv2d` takes :func:`conv2d_plan`'s; the card tests and
    ``chip_smoke.py`` use it to hold every instantiation and tile to the
    same bits.  Counted in ``conv2d.launches``."""
    _check(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d launch: {x.device} is not a CUDA device")
    if not (0 <= taps < len(CONV_TAPS) and 0 <= tile < len(CONV_TILES)) \
            or CONV_TAPS[taps] not in (None, tuple(w.shape)):
        raise ValueError(f"instantiation {taps} or tile {tile} does not take taps "
                         f"{tuple(w.shape)}")
    from .build import load_library
    (h, wd), (kh, kw) = x.shape, w.shape
    out = torch.empty((h - kh + 1, wd - kw + 1), dtype=x.dtype, device=x.device)
    err = load_library().repro_conv2d(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), h, wd, kh, kw, taps, tile,
        _DTYPES[x.dtype], ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err:
        raise RuntimeError(f"conv2d kernel launch failed: CUDA error {err}")
    conv2d.launches += 1
    return out


def prepare(device: torch.device) -> None:
    """Build and load the kernel library, check its largest tap count, then
    launch every instantiation once, each dtype, fixed or runtime taps
    (4 x 4), each tile, on a 16 x 16 image, and synchronise — so a caller's
    first timed call pays no build or module load, and a card that cannot
    launch one of them raises here.  The launches are counted like any
    other."""
    from .build import load_library
    built = load_library().repro_conv2d_max_taps()
    if built != MAX_TAPS:
        raise RuntimeError(f"library takes taps up to {built}, the wrapper "
                           f"{MAX_TAPS}")
    for dtype, taps, tile in INSTANTIATIONS:
        x = torch.zeros((16, 16), dtype=dtype, device=device)
        kh, kw = CONV_TAPS[taps] or (4, 4)
        launch(x, x[:kh, :kw].contiguous(), taps, tile)
    torch.cuda.synchronize(device)


def reset_launch_counts() -> None:
    conv2d.launches = 0
