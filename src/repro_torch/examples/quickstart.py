"""Quickstart: the VPE on your own code — the paper's mechanism in a page.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The counterpart of ``examples/quickstart.py``.  Registers a function with
two implementations, calls it in a loop, and watches the VPE profile,
trial the alternative ("blind offload"), and keep or revert it on
measurements — no knowledge of the target at the call site, as in the
paper.  Then the same mechanism on two of the paper's Table-1 benchmarks.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device
from ..bench_algos import build_vpe, make_inputs
from ..core import VPE
from ..kernels.ref import full_f32


def smooth_naive(x: torch.Tensor) -> torch.Tensor:
    """Naive 5-point circular smoothing, eager: one PyTorch op per line
    (the "naive C on the ARM core")."""
    acc = x
    for shift in (-2, -1, 1, 2):
        acc = acc + torch.roll(x, shift, dims=0)
    return acc / 5.0


def smooth_fused(x: torch.Tensor) -> torch.Tensor:
    """The same 5-point circular sum as one circular 5-tap ``conv1d`` (TF32
    off) — an alternative target someone else provides; the call site never
    changes."""
    xp = F.pad(x.view(1, 1, -1), (2, 2), mode="circular")
    taps = torch.ones((1, 1, 5), dtype=x.dtype, device=x.device)
    with full_f32():
        return F.conv1d(xp, taps)[0, 0] / 5.0


def main(device: DeviceLike = "cuda") -> Dict[str, str]:
    """Run the demonstration on ``device``; returns the two decision tables
    it prints (``smooth`` and ``bench``)."""
    dev = resolve_device(device)
    vpe = VPE(controller_kwargs=dict(min_samples=3, trial_samples=3))
    smooth = vpe.op("smooth")(smooth_naive)
    vpe.variant("smooth", variant="fused")(smooth_fused)
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4_000_000,)).astype(np.float32)).to(dev)
    for _ in range(20):
        smooth(x)  # dispatched through the VPE's caller indirection
    smooth_report = vpe.report()
    print(smooth_report)
    # the paper's Table-1 benchmarks, same mechanism
    bvpe, fns = build_vpe(with_cuda=False, device=dev)
    for name in ("matmul", "fft"):
        args = make_inputs(name, scale=0.1, device=dev)
        for _ in range(10):
            fns[name](*args)
    bench_report = bvpe.report()
    print(bench_report)
    return {"smooth": smooth_report, "bench": bench_report}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
