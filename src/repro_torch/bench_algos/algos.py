"""The six paper benchmarks with naive and accelerated variants.

The counterpart of ``repro.bench_algos.algos``.  Variants:

* ``reference`` — the naive implementation, run eagerly (one PyTorch op
  per line), the analogue of the paper's naive C on the ARM core.
* ``fused`` — the same function as one or a few PyTorch library ops, the
  counterpart of ``jax.jit`` letting XLA fuse it: LUT indexing,
  ``F.conv2d`` and ``a @ b`` (the kernels' plain versions,
  ``kernels.ref``), a windowed compare, ``torch.fft.fft``.  f32 products
  and convolutions run in full f32 (TF32 off), like the naive bodies.  No ``torch.compile``: it would need a host compiler and put its
  compile seconds into the trial samples.
* ``cuda`` (tag ``cuda``, in place of JAX's ``pallas``) — the hand-written
  kernels: ``kernels.matmul`` for matmul and ``kernels.conv2d`` for
  convolution.  On a CPU tensor they run their plain versions.
* FFT's ``dsp`` — an O(n^2) DFT by real matrix products, the paper's FFT
  row, where blind offload was a 0.7x regression that the VPE detects and
  reverts.  Its products stay ``torch.matmul``, as JAX left them to XLA.

Results keep JAX's dtypes: an int32 sum stays int32 (``torch.sum`` would
give int64), a count of matches is int32, the FFT is complex64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..core import VPE
from ..kernels import conv2d as kconv
from ..kernels import matmul as kmm
from ..kernels import ref

# --------------------------------------------------------------------------
# algorithm bodies
# --------------------------------------------------------------------------

# DNA code: A=0, C=1, G=2, T=3; complement: A<->T, C<->G  (i.e. 3 - x)


def _complement_naive(seq: torch.Tensor) -> torch.Tensor:
    """Branchy naive complement, as one would write it in C."""
    out = torch.where(seq == 0, 3, seq)
    out = torch.where(seq == 3, 0, out)
    out = torch.where(seq == 1, 2, out)
    out = torch.where(seq == 2, 1, out)
    return out


def _complement_lut(seq: torch.Tensor) -> torch.Tensor:
    lut = torch.arange(3, -1, -1, dtype=seq.dtype, device=seq.device)  # [3, 2, 1, 0]
    return lut[seq]


def _conv2d_naive(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Shift-and-MAC with explicit python loops over the taps."""
    kh, kw = w.shape
    h_out, w_out = x.shape[0] - kh + 1, x.shape[1] - kw + 1
    acc = torch.zeros((h_out, w_out), dtype=torch.float32, device=x.device)
    for di in range(kh):
        for dj in range(kw):
            acc = acc + x[di:di + h_out, dj:dj + w_out].float() * w[di, dj]
    return acc.to(x.dtype)


def _dot_naive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product, summed as torch.sum sums integers (int64), cast back to
    JAX's int32 (the same value modulo 2^32)."""
    return torch.sum(a * b).to(torch.int32)


def _dot_library(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PyTorch has no integer dot product on the card (``torch.dot`` takes
    floating types there), so the product and one int32 sum."""
    return torch.sum(a * b, dtype=torch.int32)


def _matmul_naive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-at-a-time vector-matrix products — no blocking, poor locality
    (JAX: ``lax.map`` over the rows)."""
    with ref.full_f32():
        return torch.stack([row @ b for row in a])


def _patmatch_naive(seq: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """Count occurrences of pat in seq, one shifted comparison per symbol."""
    n, p = seq.shape[0], pat.shape[0]
    hits = torch.ones((n - p + 1,), dtype=torch.bool, device=seq.device)
    for j in range(p):
        hits = hits & (seq[j:j + n - p + 1] == pat[j])
    return torch.sum(hits, dtype=torch.int32)


def _patmatch_windowed(seq: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """Every window against the pattern at once: (n-p+1, p) compare of a
    strided view, all over the window, count."""
    windows = seq.unfold(0, pat.shape[0], 1)
    return torch.sum((windows == pat).all(dim=1), dtype=torch.int32)


def _fft_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft(x)


def _dft_matmul(x: torch.Tensor) -> torch.Tensor:
    """O(n^2) DFT via real matmuls — the 'blind DSP offload' of the FFT.

    The angle matrix is built in f32 in JAX's order (``outer(j, j)``, then
    ``/ n``).  At n = 16384 its cos and sin matrices take 1 GiB each.
    """
    n = x.shape[0]
    j = torch.arange(n, dtype=torch.float32, device=x.device)
    ang = -2.0 * math.pi * torch.outer(j, j) / n
    xr = x.real.float()[None, :]
    xi = x.imag.float()[None, :]
    cr, ci = torch.cos(ang), torch.sin(ang)
    with ref.full_f32():
        re = xr @ cr - xi @ ci
        im = xr @ ci + xi @ cr
    return torch.complex(re, im)[0]


# --------------------------------------------------------------------------
# registration
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Algo:
    name: str
    make_inputs: Callable[..., Tuple]
    paper_speedup: float  # Table 1 (the paper's ARM + DSP board)


def make_inputs(name: str, scale: float = 1.0, seed: int = 0,
                device: DeviceLike = "cuda") -> Tuple[torch.Tensor, ...]:
    """Paper-comparable input sets; ``scale`` sweeps sizes (Fig. 2b).  The
    numbers are drawn with ``np.random.default_rng(seed)`` in the order of
    ``repro.bench_algos.make_inputs``, so both packages get the same ones,
    then moved to ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    s = lambda n: max(8, int(n * scale))  # noqa: E731
    if name == "complement":
        arrs = (rng.integers(0, 4, s(4_000_000), dtype=np.int32),)
    elif name == "convolution":
        x = rng.standard_normal((s(512), s(512))).astype(np.float32)
        w = rng.standard_normal((5, 5)).astype(np.float32)
        arrs = (x, w)
    elif name == "dotproduct":
        a = rng.integers(-100, 100, s(8_000_000)).astype(np.int32)
        b = rng.integers(-100, 100, s(8_000_000)).astype(np.int32)
        arrs = (a, b)
    elif name == "matmul":
        n = s(512)
        a = rng.standard_normal((n, n)).astype(np.float32)
        b = rng.standard_normal((n, n)).astype(np.float32)
        arrs = (a, b)
    elif name == "patternmatch":
        seq = rng.integers(0, 4, s(4_000_000), dtype=np.int32)
        pat = rng.integers(0, 4, 16, dtype=np.int32)
        arrs = (seq, pat)
    elif name == "fft":
        n = s(1 << 14)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        arrs = (x.astype(np.complex64),)
    else:
        raise KeyError(name)
    return tuple(torch.from_numpy(a).to(dev) for a in arrs)


ALGORITHMS: Dict[str, Algo] = {
    "complement": Algo("complement", make_inputs, 7.4),
    "convolution": Algo("convolution", make_inputs, 3.8),
    "dotproduct": Algo("dotproduct", make_inputs, 6.3),
    "matmul": Algo("matmul", make_inputs, 31.9),
    "fft": Algo("fft", make_inputs, 0.7),
    "patternmatch": Algo("patternmatch", make_inputs, 22.7),
}


def build_vpe(*, controller_kwargs: Optional[Dict] = None, with_cuda: bool = True,
              device: DeviceLike = "cuda") -> Tuple[VPE, Dict[str, Callable]]:
    """Register all six algorithms in a fresh VPE instance.

    Returns (vpe, {name: dispatchable callable}).  With ``with_cuda`` on a
    CUDA ``device``, both kernels are built and launched once here
    (``prepare``), so the first ``cuda`` trial pays no ``nvcc`` and a card
    that cannot run them fails here.
    """
    dev = resolve_device(device)
    ck = dict(min_samples=2, trial_samples=2, hysteresis=0.05)
    ck.update(controller_kwargs or {})
    vpe = VPE(controller_kwargs=ck)
    fns: Dict[str, Callable] = {}

    fns["complement"] = vpe.op("complement")(_complement_naive)
    vpe.variant("complement", variant="fused")(_complement_lut)

    fns["convolution"] = vpe.op("convolution")(_conv2d_naive)
    vpe.variant("convolution", variant="fused")(ref.conv2d_ref)   # F.conv2d
    if with_cuda:
        vpe.variant("convolution", variant="cuda", tags=("cuda",))(kconv.conv2d)

    fns["dotproduct"] = vpe.op("dotproduct")(_dot_naive)
    vpe.variant("dotproduct", variant="fused")(_dot_library)

    fns["matmul"] = vpe.op("matmul")(_matmul_naive)
    vpe.variant("matmul", variant="fused")(ref.matmul_ref)        # a @ b
    if with_cuda:
        vpe.variant("matmul", variant="cuda", tags=("cuda",))(kmm.matmul)

    fns["patternmatch"] = vpe.op("patternmatch")(_patmatch_naive)
    vpe.variant("patternmatch", variant="fused")(_patmatch_windowed)

    fns["fft"] = vpe.op("fft")(_fft_ref)
    # the paper's FFT row: blind offload to the "DSP" that loses
    vpe.variant("fft", variant="dsp")(_dft_matmul)

    if with_cuda and dev.type == "cuda":
        kmm.prepare(dev)
        kconv.prepare(dev)
    return vpe, fns
