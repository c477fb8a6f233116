"""Dry run of every (arch x shape x mesh) cell, on the meta device.

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k [--mesh 16,16]
    python -m repro_torch.launch.dryrun --all [--no-probes]    # 40 cells, (16, 16)
    python -m repro_torch.launch.dryrun --all --multi-pod      # (32, 16): 2 pods
    ... --set remat=none --build fsdp=False --tag exp --out DIR

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell for 256 (512) placeholder TPU devices and reads XLA's
compiled artifact through ``repro.launch.hlo``: its HLO text for the
collectives, ``compiled.cost_analysis()`` for FLOPs and bytes, and
``compiled.memory_analysis()`` for the temporaries.  PyTorch has no such
artifact, so ``launch/hlo.py`` is not ported.  Here one rank's step
(:mod:`repro_torch.launch.specs`: rank 0's shard, rows and cache, every
tensor on ``device="meta"``, so nothing is allocated) runs eagerly once,
and three counts take its place:

* ``cost_analysis``: ``flops`` from ``torch.utils.flop_counter.
  FlopCounterMode`` over the step, forward and backward; ``bytes_accessed``
  the operands and results of every op that is not a view (eager ops, no
  fusion: an upper bound of the traffic);
* ``collectives``: the result bytes and the count of each collective by
  kind, recorded by the rank's :class:`~repro_torch.launch.specs.
  CountingGroup` at the port's explicit collective calls (the data mean,
  the model group's sums, the fsdp all-gather and reduce-scatter);
* ``memory_analysis``: the arguments' bytes, and as ``temp_size_in_bytes``
  the bytes of the tensors autograd saves for backward during the forward
  (each storage once, the arguments' own excluded), counted with
  ``torch.autograd.graph.saved_tensors_hooks``: what stays alive into the
  backward.  Under ``remat="full"`` a recomputed layer's tensors are not
  among them (the checkpoint keeps its own), nor is what a backward saves
  for itself (the flash backward's f32 recomputation, chunk by chunk).

An eager count does not fold a loop body, so the step's totals are of the
full depth directly, where the reference extrapolates from depth probes;
``probe_totals`` still come from those probes (``roofline.probe_configs``)
for comparison.  The recurrent families are the exception: an eager count
walks every chunk of every layer's scan (rwkv6-7b's train_4k cell took 11
minutes at full depth on one core), so their step is counted at 1 and 2
layers (RWKV6) or at one macro block, two, and one with a tail layer (the
hybrid), and combined linearly (:func:`depth_probes`: exact, since their
layers run the same ops).  A train step of ``n`` microbatches is counted
at one and at two microbatches and extrapolated linearly (exact: the
microbatches run the same ops), as the reference scales its probes by
``n``.

Cells the port cannot run are written with ``skipped`` and the reason:
``long_500k`` for a quadratic arch (``shape_applicable``), as the
reference skips them.  Every family splits over the model axis (the
recurrent and encoder-decoder families' heads too), so at (16, 16) the
40 cells give 33 runs and 7 skips.  ``--multi-pod`` is a ``(32, 16)``
grid whose data axis spans the two pods: the reference's ``pod`` axis
carries only data parallelism.
``--mesh DP,MP`` sets any other grid.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_config, shape_applicable
from repro_torch.launch import roofline
from repro_torch.launch import specs as speclib

PRODUCTION = (16, 16)
MULTI_POD = (32, 16)


class _Bytes(TorchDispatchMode):
    """Sums the bytes of each op's tensor operands and results (views
    excluded)."""

    def __init__(self) -> None:
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.n += sum(t.nbytes for t in torch.utils._pytree.tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor))
        return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def count(built: speclib.Built) -> Dict[str, Any]:
    """Run ``built``'s step once under the three counters: FLOPs, bytes
    accessed, saved-for-backward bytes, and the group's collectives."""
    args = {_storage(t) for t in torch.utils._pytree.tree_leaves(built.args)
            if isinstance(t, torch.Tensor)}
    saved: Dict[int, int] = {}

    def pack(t):
        key = _storage(t)
        # -1: not inside a backward pass
        if key not in args and torch._C._current_graph_task_id() == -1:
            saved[key] = t.untyped_storage().nbytes()
        return t

    flops, nbytes = FlopCounterMode(display=False), _Bytes()
    with flops, nbytes, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        built.run()
    return dict(flops=float(flops.get_total_flops()), bytes_accessed=float(nbytes.n),
                saved=float(sum(saved.values())), collectives=built.group.summary())


def _combine(counts: List[Dict], weights: List[int],
             saved: Optional[float] = None) -> Dict:
    """The sum of ``weights[i] * counts[i]``, key by key (the saved bytes
    too, unless ``saved`` is given)."""
    def lin(get):
        return sum(w * get(c) for w, c in zip(weights, counts))
    coll = {k: lin(lambda c: c["collectives"][k]) for k in (*speclib.COLLECTIVES, "total")}
    coll["counts"] = {k: lin(lambda c: c["collectives"]["counts"][k])
                      for k in speclib.COLLECTIVES}
    return dict(flops=lin(lambda c: c["flops"]),
                bytes_accessed=lin(lambda c: c["bytes_accessed"]),
                saved=lin(lambda c: c["saved"]) if saved is None else saved,
                collectives=coll)


def _extrapolate(c1: Dict, c2: Dict, n: int) -> Dict:
    """c1 + (n - 1)(c2 - c1) of two counts at one and two microbatches (the
    saved bytes are one microbatch's)."""
    return _combine([c1, c2], [2 - n, n - 1], saved=c1["saved"])


def _microbatch_shape(shape, k: int, nmb: int):
    mb = shape.global_batch // nmb
    return dataclasses.replace(shape, global_batch=k * mb, num_microbatches=k)


def depth_probes(cfg) -> Optional[Tuple[List[Any], List[int]]]:
    """(configs, weights) whose counts, weighted and summed, are the full
    depth's, for the recurrent families: an eager count walks every chunk
    of each layer's scan, and their layers run the same ops, so a count is
    affine in the layers.  RWKV6: 1 and 2 layers; the hybrid: one macro
    block, two, and one with a tail layer.  None where counting the full
    depth is no dearer (the other families, shallow configs)."""
    rep = dataclasses.replace
    if cfg.family == "ssm" and cfg.num_layers > 3:
        L = cfg.num_layers
        return [rep(cfg, num_layers=1), rep(cfg, num_layers=2)], [2 - L, L - 1]
    if cfg.family == "hybrid" and cfg.num_layers > 4 * cfg.attn_every + 1:
        e = cfg.attn_every
        nm, tail = cfg.num_layers // e, cfg.num_layers % e
        return ([rep(cfg, num_layers=e), rep(cfg, num_layers=2 * e),
                 rep(cfg, num_layers=e + 1)], [2 - nm - tail, nm - 1, tail])
    return None


def _count_microbatches(cfg, shape, mesh, bkw: Dict, built: speclib.Built) -> Dict:
    """The counts of ``built``: a train step of ``n`` microbatches counted at
    one and two and extrapolated."""
    n = built.num_microbatches
    if shape.kind != "train" or n == 1:
        return count(built)
    one = [count(speclib.build(cfg, _microbatch_shape(shape, k, n), mesh,
                               **{**bkw, "num_microbatches": k})) for k in (1, 2)]
    return _extrapolate(*one, n)


def count_step(cfg, shape, mesh, bkw: Dict) -> Tuple[speclib.Built, Dict]:
    """(the cell's build, its counts): a train step of ``n`` microbatches is
    counted at one and two and extrapolated; a recurrent family's step is
    counted at the depths of :func:`depth_probes` (with the full config's
    layout) and combined."""
    built = speclib.build(cfg, shape, mesh, **bkw)
    probes = depth_probes(cfg)
    if probes is None:
        return built, _count_microbatches(cfg, shape, mesh, bkw, built)
    # the full config's layout: a shallower one may fall under auto_tp's
    # or auto_fsdp's thresholds
    pin = {**bkw, "tp": built.tp, "fsdp": built.fsdp} if shape.kind == "train" else bkw
    counts = [_count_microbatches(c, shape, mesh, pin, speclib.build(c, shape, mesh, **pin))
              for c in probes[0]]
    return built, _combine(counts, probes[1])


def _probe(cfg, shape, mesh, bkw: Dict) -> roofline.Probe:
    c = count(speclib.build(cfg, shape, mesh, **bkw))
    return roofline.Probe(c["flops"], c["bytes_accessed"], float(c["collectives"]["total"]))


def _mesh_name(mesh: Tuple[int, int], multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else f"{mesh[0]}x{mesh[1]}"


def skip_reason(cfg, shape) -> Optional[str]:
    """Why the port cannot run the cell, or None."""
    ok, reason = shape_applicable(cfg, shape)
    return None if ok else reason


def run_cell(arch: str, shape_name: str, *, mesh: Tuple[int, int] = PRODUCTION,
             multi_pod: bool = False, probes: bool = True,
             overrides: Optional[Dict] = None,
             build_kwargs: Optional[Dict] = None) -> Dict:
    """One cell's result (the reference's keys, each filled by the port's
    counterpart; see the module docstring)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES_BY_NAME[shape_name]
    grid = speclib.dry_mesh(*(MULTI_POD if multi_pod else mesh))
    name = _mesh_name(grid.shape, multi_pod)
    bkw = dict(build_kwargs or {})
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": name, "skipped": reason}
    n_dev = grid.shape[0] * grid.shape[1]
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": name, "devices": n_dev,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "overrides": overrides or {},
        "build_kwargs": dict(bkw),
    }
    t0 = time.time()
    built, c = count_step(cfg, shape, grid, bkw)
    result.update(fsdp=built.fsdp, tp=built.tp, rank_mesh=list(built.mesh),
                  num_microbatches=built.num_microbatches)
    result["count_s"] = round(time.time() - t0, 1)
    arg_bytes = speclib.tree_bytes(built.args)
    result["arg_bytes_per_device"] = arg_bytes
    result["state_bytes_per_device"] = speclib.tree_bytes(built.state)
    result["memory_analysis"] = {"argument_size_in_bytes": arg_bytes,
                                 "temp_size_in_bytes": c["saved"]}
    result["cost_analysis"] = {"flops": c["flops"], "bytes_accessed": c["bytes_accessed"]}
    result["collectives"] = c["collectives"]
    total = roofline.Probe(c["flops"], c["bytes_accessed"],
                           float(c["collectives"]["total"]))
    rl = roofline.derive(total, model_flops_per_device=roofline.model_flops(
        cfg, shape, n_dev))
    rl.memory_floor_s = (arg_bytes + c["saved"]) / roofline.HBM_BW
    result["roofline"] = rl.as_dict()
    if probes and not multi_pod:
        probe_cfgs, total_fn = roofline.probe_configs(cfg)
        pshape, pbkw, repeats = shape, dict(bkw), 1.0
        if shape.kind == "train":
            nmb = speclib.effective_microbatches(cfg, shape, grid, bkw)
            pshape = _microbatch_shape(shape, 1, nmb)
            repeats = float(nmb)
            # the cell's layout, not the one "auto" would give the smaller
            # probe configs (a 1-layer model may fall under auto_tp's floor)
            pbkw.update(num_microbatches=1, tp=built.tp, fsdp=built.fsdp)
        vals = [_probe(pc, pshape, grid, pbkw) for pc in probe_cfgs]
        pt = total_fn(*vals).scale(repeats)
        result["probe_totals"] = {"flops": pt.flops, "bytes_accessed": pt.bytes_accessed,
                                  "collective_bytes": pt.collective_bytes}
    return result


def cell_filename(result: Dict) -> str:
    return f"{result['arch']}__{result['shape']}__{result['mesh']}.json".replace("/", "_")


def parse_kv(items) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for kv in items:
        k, _, v = kv.partition("=")
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        elif v.isdigit():
            v = int(v)
        elif v.lower() in ("none", "null"):
            v = None
        out[k] = v
    return out


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. remat=none)")
    ap.add_argument("--build", action="append", default=[],
                    help="a build_train/prefill/decode argument key=value (e.g. fsdp=False)")
    ap.add_argument("--tag", default="", help="suffix for the output file")
    ap.add_argument("--mesh", default="16,16", metavar="DP,MP",
                    help="the (data, model) grid (default the reference's 16,16)")
    args = ap.parse_args(argv)
    try:
        mesh = tuple(int(x) for x in args.mesh.split(","))
    except ValueError:
        mesh = ()
    if len(mesh) != 2 or min(mesh) < 1:
        ap.error(f"--mesh must be 'dp,mp' integers >= 1, got {args.mesh!r}")
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    overrides, build_kwargs = parse_kv(args.set), parse_kv(args.build)
    cells = ([(a, s) for a in ARCHS for s in SHAPES_BY_NAME] if args.all
             else [(args.arch, args.shape)])
    os.makedirs(args.out, exist_ok=True)
    tally = {"ok": 0, "skipped": 0, "error": 0}
    for arch, shape in cells:
        try:
            r = run_cell(arch, shape, mesh=mesh, multi_pod=args.multi_pod,
                         probes=not args.no_probes, overrides=overrides,
                         build_kwargs=build_kwargs)
        except Exception as e:      # a cell's failure is its result
            r = {"arch": arch, "shape": shape,
                 "mesh": _mesh_name(mesh, args.multi_pod),
                 "error": f"{type(e).__name__}: {e}",
                 "traceback": traceback.format_exc()}
        name = cell_filename(r)
        if args.tag:
            name = name.replace(".json", f"__{args.tag}.json")
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(r, f, indent=1)
        if "skipped" in r:
            tally["skipped"] += 1
            print(f"[skip] {arch} x {shape}: {r['skipped']}", flush=True)
        elif "error" in r:
            tally["error"] += 1
            print(f"[FAIL] {arch} x {shape}: {r['error']}", flush=True)
        else:
            tally["ok"] += 1
            rl = r["roofline"]
            print(f"[ok] {arch} x {shape} ({r['mesh']}): counted in {r['count_s']}s "
                  f"dominant={rl['dominant']} roofline_frac="
                  f"{rl['roofline_fraction']:.3f} useful_ratio={rl['useful_ratio']:.3f}",
                  flush=True)
    print(f"cells: {tally['ok']} ok, {tally['skipped']} skipped, {tally['error']} error")
    if tally["error"]:
        raise SystemExit(f"{tally['error']} cell(s) failed")
    return tally


if __name__ == "__main__":
    main()
