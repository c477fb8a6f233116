#!/usr/bin/env python3
"""Phases 10 and 11 of ``chip_smoke.py`` on the kernels of any tree, for
comparing a parent and a change on one card.

    PYTHONPATH=<tree>/src python3 tools/paper_times.py LABEL [--outputs FILE]
    python3 tools/paper_times.py --compare FILE FILE

Imports ``chip_smoke.py`` from this checkout and runs, on the
``repro_torch`` found on ``PYTHONPATH``, its phase 10 (matmul and conv2d at
the paper path's shapes: the kernel's time by CUDA events and, for conv2d,
its device time read from torch.profiler; the plain version's and the
library call's times, the bound, the launch floor) and its phase 11 (Table
1, the Fig. 2b sweep, the image pipeline, the quickstart).  It prints one
line ``RESULT {...}``: the conv2d rows of phase 10, the launch floor,
Table 1's convolution row and the image pipeline's fps.  ``--outputs``
also writes the f32 conv2d outputs at the two path shapes (512^2 * 5x5,
384^2 * 3x3; inputs from a numpy seed) to FILE; ``--compare`` checks two
such files bit for bit, on any machine.  To compare a parent with a
change, unpack the parent with ``git archive`` into a directory that
``.gitignore`` lists and run, one process each, all in one chip call:
parent, change, change, parent.  Imports nothing of JAX.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PATH_SHAPES = ((512, 5), (384, 3))


def conv_outputs(dev) -> dict:
    from repro_torch.kernels import conv2d as kconv
    rng = np.random.default_rng(19)
    out = {}
    for hw, k in PATH_SHAPES:
        x = torch.from_numpy(rng.standard_normal((hw, hw)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, k)).astype(np.float32)).to(dev)
        out[f"{hw}^2 * {k}x{k}"] = kconv.conv2d(x, w).cpu()
    return out


def compare(a: Path, b: Path) -> int:
    first, second = torch.load(a), torch.load(b)
    same = {key: torch.equal(first[key], second[key]) for key in first}
    print(f"conv2d f32 outputs of {a.name} and {b.name}, bit for bit: {same}")
    return 0 if all(same.values()) and first.keys() == second.keys() else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("label", nargs="?", default="tree")
    ap.add_argument("--outputs", type=Path, default=None)
    ap.add_argument("--compare", type=Path, nargs=2, default=None)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("paper_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(1, str(ROOT))       # chip_smoke; repro_torch from PYTHONPATH
    import chip_smoke
    import repro_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"{args.label}: repro_torch from {Path(repro_torch.__file__).parent}")
    times = chip_smoke.phase_paper_kernel_times(dev)
    paper = chip_smoke.phase_paper_path(dev)
    conv_row = next(r for r in paper["table1"] if r["name"] == "convolution")
    pipeline = paper["image_pipeline"]
    if args.outputs:
        args.outputs.parent.mkdir(parents=True, exist_ok=True)
        torch.save(conv_outputs(dev), args.outputs)
    print("RESULT " + json.dumps(dict(
        label=args.label, launch_floor_ms=times["launch floor"],
        conv2d={k: v for k, v in times.items() if k.startswith("conv2d ")},
        table1_convolution={k: conv_row[k] for k in (
            "naive_ms", "vpe_ms", "speedup", "decision", "variant_ms")},
        image_pipeline={k: pipeline[k] for k in (
            "fps_before", "fps_after", "ratio", "decision")},
        launches=paper["launches"]), default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
