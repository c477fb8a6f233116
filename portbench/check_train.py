"""Whether a training run's first steps are right, judged by the plain
reference.

After the window, with the program freed, the reference of the
configuration's family (``reference/<family>.py``) makes the same initial
weights again from the seed (in the served dtype, then f32), takes
the same batches and follows the checked steps in f32 with TF32 off.  Three
numbers are compared, each a gap of the program's reading from the
reference's, over the worst leaf where there are leaves:

* ``loss_gap``: the loss of each of the first ``loss_steps`` checked steps
  (the cell file's; those that run on the initial weights, the schedule's
  first learning rate being 0), |program - reference| over the reference.
  A later step's loss follows AdamW's first moves of 3e-5 and 6e-5, which
  bf16 compute weights (the configuration's) mostly cannot hold and the
  f32 reference holds whole: its gap is reported (``loss_gaps`` on
  standard error), not compared;
* ``first_grad_gap``: each leaf's norm of the first gradient as the
  optimizer got it (before the clip), |program - reference| over the larger
  of the reference leaf's norm and the median leaf's;
* ``change_gap``: each leaf's norm of its change over the checked steps,
  the same way; leaves whose first reference gradient is under a thousandth
  of the median leaf's are left out (they move by round-off alone).

The control is the reference computed with fp8 weight products, put in
the program's place: its three numbers are judged under the plain names, so
a control run comes out not correct, and the program's own are reported
beside them as ``program_<name>``, judged by the same limits.
``half_rows`` is a fault planted in the reference put in the program's
place (each loss over half the positions), judged the same way
(``half_rows_<name>``).
"""

from __future__ import annotations

import gc
import math
import statistics
from typing import Dict, List

import torch

from portbench import families, weights
from portbench.harness import log
from portbench.reference import common


def family_loss(d):
    """The loss of ``d``'s family's reference (``reference/<family>.py``)."""
    ref = families.reference(d.family)
    if not hasattr(ref, "loss"):
        raise NotImplementedError(
            f"portbench/reference/{d.family}.py has no loss: the {d.family} family "
            f"trains in no cell until its reference gives one")
    return ref.loss


def reference_run(d, seed: int, device, batches, conf: Dict, steps: int,
                  precision: str = "f32", half_rows: bool = False) -> Dict:
    dt = getattr(torch, d.dtype)
    params = {}
    for i, spec in enumerate(weights.leaf_specs(d)):
        params[spec[0]] = weights.make_leaf(spec, seed, i, device, dt).to(torch.float32)
    data = []
    for s in range(steps):
        b = batches.batch_at(s)
        data.append((torch.from_numpy(b["tokens"]).to(device),
                     torch.from_numpy(b["labels"]).to(device)))
    port = conf["port"]
    out = common.train(family_loss(d), d, params, data, port["optimizer"], port["schedule"],
                       precision=precision, half_rows=half_rows)
    change = {}
    for i, spec in enumerate(weights.leaf_specs(d)):
        init = weights.make_leaf(spec, seed, i, device, dt).to(torch.float32)
        change[spec[0]] = float(torch.linalg.vector_norm(params[spec[0]] - init))
        del init
    out["change_norms"] = change
    del params, data
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def leaf_gap(seen: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    keys = [k for k in want if keep is None or keep(k)]
    floor = statistics.median(want[k] for k in keys)
    return max(abs(seen[k] - want[k]) / max(want[k], floor) for k in keys)


def worst_leaf(seen: Dict[str, float], want: Dict[str, float], keep=None) -> str:
    keys = [k for k in want if keep is None or keep(k)]
    floor = statistics.median(want[k] for k in keys)
    return max(keys, key=lambda k: abs(seen[k] - want[k]) / max(want[k], floor))


def loss_gaps(seen: Dict, want: Dict) -> List[float]:
    return [abs(a - b) / abs(b) for a, b in zip(seen["loss"], want["loss"])]


def gaps(seen: Dict, want: Dict, loss_steps: int) -> Dict[str, float]:
    g = want["first_grad_norms"]
    floor = statistics.median(g.values())
    moved = lambda k: g[k] >= 1e-3 * floor  # noqa: E731
    loss = max(loss_gaps(seen, want)[:loss_steps])
    return {"loss_gap": loss,
            "first_grad_gap": leaf_gap(seen["first_grad_norms"], g),
            "change_gap": leaf_gap(seen["change_norms"], want["change_norms"], moved)}


def check(d, seed: int, device, batches, conf: Dict, cell: Dict, seen: Dict,
          control=False) -> List[tuple]:
    """The compared numbers, each ``(name, value, limit)``; ``control`` may
    name reference variants to read besides ("fp8", "half_rows"), or be
    True for "fp8"."""
    steps = len(seen["loss"])
    limits = cell["limits"]
    loss_steps = int(cell["loss_steps"])
    want = reference_run(d, seed, device, batches, conf, steps)
    finite = all(math.isfinite(x) for x in seen["loss"])
    got = gaps(seen, want, loss_steps) if finite else {k: float("nan") for k in limits}
    if finite:
        g = want["first_grad_norms"]
        floor = statistics.median(g.values())
        log(f"losses {seen['loss']} against {want['loss']}: loss_gaps "
            f"{loss_gaps(seen, want)}; worst leaf of first_grad_gap "
            f"{worst_leaf(seen['first_grad_norms'], g)}, of change_gap "
            f"{worst_leaf(seen['change_norms'], want['change_norms'], lambda k: g[k] >= 1e-3 * floor)}"
            f"; leaves left out of change_gap {[k for k in g if g[k] < 1e-3 * floor]}")
    names = ("loss_gap", "first_grad_gap", "change_gap")
    variants = ["fp8"] if control is True else list(control or [])
    own = "program_" if "fp8" in variants else ""
    checks = [(own + k, got[k], float(limits[k])) for k in names]
    for v in variants:
        run = reference_run(d, seed, device, batches, conf, steps,
                            precision="fp8" if v == "fp8" else "f32",
                            half_rows=(v == "half_rows"))
        pre = "" if v == "fp8" else f"{v}_"
        for k, x in gaps(run, want, loss_steps).items():
            checks.append((pre + k, x, float(limits[k])))
        log(f"control {v}: loss_gaps {loss_gaps(run, want)}")
    return checks


def passed(checks: List[tuple]) -> bool:
    """Every compared number at most its limit (a NaN fails)."""
    return bool(all(v <= lim for _, v, lim in checks))
