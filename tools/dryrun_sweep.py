"""Time the launch dry run's sweep on the host, as phase 17d of
``chip_smoke.py`` runs it (its ``DryRunSweep``): the 40 (arch x shape) cells
at (16, 16), ``--no-probes``, in ``SWEEP_WORKERS`` processes that claim the
cells heaviest first, one thread each, no card.  Prints each cell's
seconds, the tally and the wall.

    PYTHONPATH=src python tools/dryrun_sweep.py [--cells ARCH:SHAPE,...]
        [--full-depth] [--workers N]

``--full-depth`` counts the recurrent families' steps at full depth
(``dryrun.depth_probes`` off): the count before the depth probes.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=None, help="ARCH:SHAPE,... (default: all 40)")
    ap.add_argument("--full-depth", action="store_true")
    ap.add_argument("--workers", type=int, default=chip_smoke.SWEEP_WORKERS)
    args = ap.parse_args(argv)
    cells = [tuple(c.split(":")) for c in args.cells.split(",")] if args.cells else None
    sweep = chip_smoke.DryRunSweep(cells, workers=args.workers, full_depth=args.full_depth)
    try:
        res = sweep.result(timeout=24 * 3600.0)
    finally:
        sweep.stop()
    for line in res["lines"]:
        if line.startswith(("cell ", "[FAIL]")):
            print(line)
    print(f"{res['counts']} in {res['wall_s']:.1f} s, {args.workers} workers, "
          f"{'full depth' if args.full_depth else 'depth probes'}, worst exit {res['rc']}")
    return res["rc"] or 0


if __name__ == "__main__":
    sys.exit(main())
