"""The paper's Fig. 3 demonstrator: contour detection on a video stream.

    PYTHONPATH=src python -m repro_torch.examples.image_pipeline [--device cpu]

The counterpart of ``examples/image_pipeline.py``.  A frame loop runs edge
detection (a 3 x 3 Laplacian, 2-D convolution) through the VPE.  For the
first phase the VPE only observes (the paper's "predefined time interval
to let spectators watch"); then it is granted the right to optimize,
trials the other targets (``fused``: ``F.conv2d``; ``cuda``: the conv2d
kernel), keeps the measured fastest, and the frame rate moves — the
console prints the fps trace.  Frames are made on the host and copied to
the device inside the loop, as a camera's would be.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..bench_algos import build_vpe
from ..core import shape_bucket

EDGE_KERNEL = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
FRAMES, GRANT_AT = 60, 24


def synth_frame(t: int, hw: int = 384) -> np.ndarray:
    """A moving blob: deterministic synthetic 'video' (f32, hw x hw)."""
    y, x = np.mgrid[0:hw, 0:hw].astype(np.float32)
    cx, cy = hw / 2 + hw / 4 * np.sin(t / 7), hw / 2 + hw / 4 * np.cos(t / 9)
    return np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (hw / 8) ** 2).astype(np.float32)


def main(device: DeviceLike = "cuda", hw: int = 384) -> Dict[str, Any]:
    """Run the frame loop on ``device`` with hw x hw frames.  Returns the
    medians it prints (fps before the grant over frames 6..23, after it
    from frame 40 on), their ratio, the fps trace, the decision and its
    history, and the decision table."""
    dev = resolve_device(device)
    vpe, fns = build_vpe(device=dev)
    conv = fns["convolution"]
    kernel = torch.from_numpy(EDGE_KERNEL).to(dev)
    # phase 1: observation only
    vpe.controller.min_samples = 10 ** 9
    fps_trace = []
    bucket = None
    window = time.perf_counter()
    for t in range(FRAMES):
        if t == GRANT_AT:
            print(">>> VPE granted the right to optimize <<<")
            vpe.controller.min_samples = 3
        frame = torch.from_numpy(synth_frame(t, hw)).to(dev)
        conv(frame, kernel)
        now = time.perf_counter()
        fps = 1.0 / max(now - window, 1e-9)
        window = now
        fps_trace.append(fps)
        bucket = shape_bucket(frame, kernel)
        if t % 6 == 5:
            sel = vpe.controller.selected("convolution", bucket)
            print(f"frame {t:3d}: {fps:6.1f} fps  (target={sel})")
    before = float(np.median(fps_trace[6:GRANT_AT]))
    after = float(np.median(fps_trace[GRANT_AT + 16:]))
    print(f"\nmedian fps before VPE: {before:.1f}; after: {after:.1f} "
          f"({after / before:.2f}x; paper reports 4x on the REPTAR board)")
    report = vpe.report()
    print(report)
    decision = vpe.controller.decision("convolution", bucket)
    return {"fps_before": before, "fps_after": after, "ratio": after / before,
            "fps_trace": fps_trace, "decision": decision.selected,
            "history": list(decision.history), "report": report}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
