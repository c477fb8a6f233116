"""Training cells: ``TrainLoop.run_step`` on batches from the data pipeline.

Set-up makes the weights from the seed on the device, hands them to one
``TrainLoop`` (AdamW, the port's schedule, the attention pinned by the
configuration, no VPE trial, no watchdog) and drives it through its first
``checked_steps`` steps with the window's own call and feed (a
``Prefetcher`` over the seeded batches, each step's rows new).  Those steps
are read for the check: each loss, the first gradient as the optimizer got
it (from ``m`` after step 1: ``m = (1 - b1) * clip * g``) and, after the
last, each leaf's change from its initial value (made again from the
seed).  The same loop then runs the window.  Afterwards the program is
freed and the reference follows the checked steps (:mod:`portbench.
check_train`).

With ``--trace 1`` the window's last ``trace_steps`` steps (as the step
before them predicts) run under the profiler.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from portbench import check_train, families, generate, weights
from portbench.harness import log
from portbench.trace import Tracer


@dataclasses.dataclass
class Obs:
    kind: str
    cfg: object
    traffic: Dict
    setup_s: float
    window_s: float
    steps: int
    tokens: int
    traced_steps: int
    trace: object
    memory_peak_bytes: int
    checks: List[tuple]
    finished: int = 0
    failed: int = 0


def leaf_norms(tree) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.float()))
            for k, t in weights.flatten(tree).items()}


def change_norms(d, seed: int, master, device) -> Dict[str, float]:
    """Each leaf's distance from its initial value (made again from the
    seed), one layer slice at a time."""
    out = {}
    for path, leaf in weights.flatten(master).items():
        init = weights.remake(d, seed, path, device, getattr(torch, d.dtype))
        sq = 0.0
        for a, b in zip(leaf.split(1), init.split(1)):
            sq += float(torch.linalg.vector_norm(a - b.float())) ** 2
        out[path] = math.sqrt(sq)
        del init
    return out


def run(spec, seed: int, seconds: float, trace: bool, device, t0: float,
        control: bool = False, fault=None) -> Obs:
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig

    conf, traffic = spec.config, spec.traffic
    fam = families.for_config(conf)
    d = fam.dims(conf)
    check_train.family_loss(d)   # a family whose reference has no loss trains nowhere
    cfg = fam.port_config(conf, d)
    port = conf["port"]
    dev = torch.device(device)
    opt, sched = port["optimizer"], port["schedule"]
    batches = generate.TrainBatches(traffic, d.vocab_size, seed)
    params = weights.make_params(d, seed, dev, getattr(torch, d.dtype))
    loop = TrainLoop(
        cfg, TrainLoopConfig(total_steps=sched["total_steps"], peak_lr=sched["peak_lr"],
                             warmup_steps=sched["warmup_steps"], log_every=0,
                             enable_vpe=False, watchdog=False),
        batches, opt_cfg=AdamWConfig(**opt), params=params, device=dev)
    del params
    if fault is not None:
        fault(loop)
    feed = Prefetcher(iter(batches), depth=int(traffic["prefetch"]))
    tracer = Tracer(dev) if trace else None
    try:
        seen = {"loss": [], "grad_norm": []}
        for i in range(int(traffic["checked_steps"])):
            m = loop.run_step(next(feed))
            seen["loss"].append(m["loss"])
            seen["grad_norm"].append(m["grad_norm"])
            if i == 0:
                gn = m["grad_norm"]
                clip = min(1.0, opt["grad_clip"] / (gn + 1e-9)) if opt["grad_clip"] else 1.0
                scale = (1 - opt["b1"]) * clip
                seen["first_grad_norms"] = {k: v / scale for k, v in
                                            leaf_norms(loop.opt_state["m"]).items()}
        master = loop.opt_state.get("master", loop.params)
        seen["change_norms"] = change_norms(d, seed, master, dev)
        log(f"checked steps: losses {seen['loss']}, grad norms {seen['grad_norm']}")
        if tracer is not None:
            tracer.warm()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_start = time.perf_counter()
        setup_s = t_start - t0
        t_end = t_start + seconds
        # the trace covers the window's last ``trace_steps`` steps, as the
        # last step's time predicts them: the profiler's stop and the
        # reading of its records come after the window closes
        steps, traced, got = 0, 0, None
        last = time.perf_counter()
        want = int(traffic["trace_steps"])
        while True:
            with record_function("portbench.train_step"):
                m = loop.run_step(next(feed))
            steps += 1
            if not math.isfinite(m["loss"]):
                raise FloatingPointError(f"loss {m['loss']} at window step {steps}")
            now = time.perf_counter()
            step_s, last = now - last, now
            if traced:
                traced += 1
            if now >= t_end:
                break
            if tracer is not None and not traced and now + (want + 0.5) * step_s >= t_end:
                tracer.start()
                traced = 1
        t_stop = now
        if traced:
            got = tracer.stop()
            traced -= 1
        log(f"window: {steps} steps in {t_stop - t_start:.3f} s, losses to {m['loss']:.4f}")
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finally:
        feed.close()
    del loop, master
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check_train.check(d, seed, dev, batches, conf, spec.cell, seen,
                               control=control)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    rows = int(traffic["batch"]) * int(traffic["seq_len"])
    return Obs(kind="train", cfg=d, traffic=traffic, setup_s=setup_s,
               window_s=t_stop - t_start, steps=steps, tokens=steps * rows,
               traced_steps=traced, trace=got,
               memory_peak_bytes=int(peak), checks=checks, finished=steps)
