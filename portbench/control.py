"""Readings for the limits of ``cells/<cell>.json``, on the card.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 30 \\
        [--variants fp8,half_rows]

runs the cell once a seed in one process, as ``run.py`` does, with the
control (the reference with fp8 weight products) in the program's place:
the control's numbers are judged by the cell's limits, so ``correct`` reads
false, and the program's own are reported beside them (``program_<name>``);
for a training cell also the faults planted in the reference
(``half_rows``).  One JSON line a seed.  The benchmark's own runs never run
this.
"""

import json
import sys
import time

import run  # noqa: F401  (paths and cache directories, as a run sets them)
from portbench import harness


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variants", default="fp8")
    args = ap.parse_args()
    bench = harness.load_benchmark()
    variants = [v for v in args.variants.split(",") if v]
    print(f"control: {args.workload} on {harness.power_limit()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             t0=time.perf_counter(), bench=bench, control=variants)
        print(json.dumps({"seed": seed, "correct": r["correct"], "metrics": r["metrics"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
