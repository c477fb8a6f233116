"""Run one cell of ``BENCHMARK.json`` once and make its result line.

Everything particular to a configuration, a traffic mix, a cell or a metric
is a file found by its name: ``configs/`` (the file ``BENCHMARK.json``
names; its ``port.family`` picks ``families/<family>.py`` and
``reference/<family>.py``), ``traffic/<traffic>.json`` (its ``driver`` picks
``drivers/<driver>.py``), ``cells/<cell>.json`` (the check's sample and
limits) and ``metrics/<metric>.py`` (a reader ``read(obs)`` returning a
number, or None when the run has nothing for it to read).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Spec:
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    cell: Dict


def log(msg: str) -> None:
    """A progress line on standard error."""
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Optional[Path] = None) -> Dict:
    return load_json(path or ROOT / "BENCHMARK.json")


def cell_spec(bench: Dict, name: str, root: Path = ROOT) -> Spec:
    """The files of cell ``name``, under the checkout ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(root / confs[w["config"]]["file"])
    here = root / HERE.name
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    cell = load_json(here / "cells" / f"{name}.json")
    return Spec(name=name, workload=w, config=conf, traffic=traffic, cell=cell)


def metrics_for(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer metrics
    (true): those whose ``workloads`` list it, or that have no list and
    move (per-layer) an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


def reader(name: str) -> ModuleType:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t0: float,
             device: str = "cuda", bench: Optional[Dict] = None,
             spec: Optional[Spec] = None, control=False, fault=None) -> Dict:
    """Run the cell once; returns the result line as a dict (``checks``
    last).  ``spec`` replaces the files' (tests run small cells on the
    CPU); ``fault(obj)`` gets the engine or train loop before set-up runs
    (tests break the timed path there)."""
    import torch
    bench = bench or load_benchmark()
    spec = spec or cell_spec(bench, name)
    driver = importlib.import_module(f"portbench.drivers.{spec.traffic['driver']}")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    obs = driver.run(spec, seed, seconds, trace, dev, t0, control=control, fault=fault)
    check = importlib.import_module(f"portbench.check_{obs.kind}")
    metrics = {}
    for m in metrics_for(bench, name, trace):
        value = reader(m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(spec.workload.get("chips", 1)),
        "memory_peak_bytes": obs.memory_peak_bytes,
    }
    if trace and obs.trace is not None:
        device_info["busy_s"] = obs.trace.busy_s
        device_info["window_s"] = obs.trace.window_s
    result = {
        "correct": check.passed(obs.checks),
        "attempted": int(obs.finished + obs.failed),
        "failed": int(obs.failed),
        "metrics": metrics,
        "device": device_info,
    }
    if trace and obs.trace is not None:
        result["breakdown"] = {"device_ops": obs.trace.top_ops(),
                               "idle_gaps": obs.trace.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in obs.checks}
    return result


def main(argv: Optional[List[str]] = None, t0: float = 0.0) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    spec = cell_spec(bench, args.workload)
    import torch
    chips = int(spec.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {power_limit()}",
          file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t0=t0, bench=bench, spec=spec)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
