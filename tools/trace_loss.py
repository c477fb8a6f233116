#!/usr/bin/env python3
"""Whether torch.profiler keeps every device record of a window late in a
long process.

    python3 tools/trace_loss.py [--windows 6]

Runs ``chip_smoke.py``'s phases 1 to 5b in this process, as its ``main``
does (phase 4's full-width qwen3-8b, and minutes of profiled and
unprofiled work before the windows), then profiles 8 steady decode steps
of that model ``--windows`` times on a new engine each time (graph
replays at 4 busy slots, phase 6's window), alternately with no idle
margin and with 0.25 s of idle time before and after the work inside the
profiler's window.  Each window's device records (kernels, copies, fills)
are counted and compared, name by name in time order, with the longest
window's: the positions of the records missing from each are printed.
The windows do the same work, so a complete window has as many records
as the longest.  Its last line is a JSON object of the counts.  Needs a
CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import difflib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

MARGINS = (0.0, 0.25)


def window_records(engine, steps, margin):
    """The device records of ``steps`` steady decode calls profiled with
    ``margin`` seconds of idle time inside the window on each side, as
    their kernel names in time order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        time.sleep(margin)
    events = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    return [name for _, name in events]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=6)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_loss: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cs.phase_environment()
    cs.phase_build()
    cs.phase_kernel_checks(dev)
    cs.phase_kernel_times(dev, [len(p) for p in cs.traffic(cs.VOCAB)])
    cs.phase_flash_checks(dev)
    cs.phase_flash_time(dev, get_config(cs.TRAIN_ARCH))
    cfg, params, prompts, main_run = cs.phase_main_path(dev)
    logits = main_run.pop("first_logits")
    cs.phase_fused_horizons(cfg, params, dev, prompts, main_run).pop("first_logits")
    cs.phase_auto_horizon(cfg, params, dev, prompts, main_run)
    _, cold = cs.phase_prefix_cache(cfg, params, dev)
    cs.phase_layouts(cfg, params, dev, prompts, main_run, logits, cold)
    cs.phase_pressure(cfg, params, dev, prompts, main_run, logits)
    cs.phase_speculation(cfg, params, dev, prompts, main_run, logits)
    cs.phase_faults(cfg, params, dev, prompts, main_run, logits)
    cs.phase_reduced_parity(dev)
    cs.phase_full_width_parity(cfg, params, dev, prompts[:cs.SLOTS], atol=0.25)
    cs.say(f"[trace_loss] phases 1-5b done at {time.perf_counter() - t0} s; "
           f"{args.windows} windows of 8 steady decode steps follow")
    windows = []
    for k in range(args.windows):
        margin = MARGINS[k % len(MARGINS)]
        engine = ContinuousBatchingEngine(cfg, params, decode_horizon=1,
                                          **cs.trace_engine_kw(dev))
        for i, p in enumerate(cs.traffic(cfg.vocab_size, seed=5)[:cs.SLOTS]):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=cs.NEW_TOKENS))
        while engine.num_decoding < cs.SLOTS:
            engine.step()
        windows.append((margin, window_records(engine, 8, margin)))
        del engine
    full = max((names for _, names in windows), key=len)
    out = []
    for k, (margin, names) in enumerate(windows):
        matcher = difflib.SequenceMatcher(None, full, names, autojunk=False)
        missing = [i for tag, i1, i2, _, _ in matcher.get_opcodes()
                   if tag in ("delete", "replace") for i in range(i1, i2)]
        decode = sum(1 for n in names if "paged_decode" in n)
        out.append(dict(window=k, margin_s=margin, records=len(names),
                        decode_records=decode, missing_positions=missing[:20]))
        cs.say(f"  window {k}, margin {margin} s: {len(names)} device records of "
               f"{len(full)}, decode kernels {decode} (expected "
               f"{3 * 8 * cfg.num_layers}); missing at positions {missing[:20]}"
               + (f" ({full[missing[0]][:60]} first)" if missing else ""))
    cs.say(json.dumps({"windows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
