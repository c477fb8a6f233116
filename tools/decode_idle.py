#!/usr/bin/env python3
"""The device's idle time a decode step of the serve engine.

    PYTHONPATH=src python3 tools/decode_idle.py [--steps N] [--horizon H]

Serves full-width qwen3-8b (random weights from a seed) on the engine of
``chip_smoke.py``'s phase 4 (slots 4, max_len 1024, block 16, chunk 128,
both paged kernels pinned) with a prompt decoding in every slot, and times
two windows of N steady decode calls each:

1. **unprofiled**: engine steps back to back on the host clock (the wall);
   where the engine replays CUDA graphs (``engine.graphs``), CUDA events
   around each replay give its device span;
2. **profiled**: the next N calls under torch.profiler; the device's busy
   time is the sum of its kernels' and copies' durations, read from device
   timestamps (the profiler's cost falls on the host clock, not on them).

Idle a step is (wall - busy) / steps, and for a graph engine also (wall -
span) / steps.  An eager engine issues its kernels one by one, so the
device waits inside any span that events could time: the busy sum is the
measure that serves both kinds.  (Queuing an eager step behind a sleep
kernel does not work: its ~3,600 launches overfill the launch queue and
the host blocks.)  The script reads whichever tree is on ``PYTHONPATH``,
so a parent and a change are measured alike in one call.  Its last line
is a JSON object of the numbers.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

SLOTS, MAX_LEN, BS, CHUNK = 4, 1024, 16, 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8,
                    help="decode calls in each window")
    ap.add_argument("--horizon", type=int, default=1,
                    help="the engine's decode_horizon (1 = single steps)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_idle: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import VPE
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen3-8b")
    params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(0))
    kw = {} if args.horizon == 1 else dict(decode_horizon=args.horizon)
    engine = ContinuousBatchingEngine(
        cfg, params, vpe=VPE(), slots=SLOTS, max_len=MAX_LEN, block_size=BS,
        kv_layout="paged", prefill_chunk=CHUNK, decode_impl="cuda",
        prefill_kernel="cuda", device=dev, **kw)
    rng = np.random.default_rng(5)
    for i, n in enumerate(rng.integers(64, 513, SLOTS)):
        engine.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                              .astype(np.int32), max_new_tokens=400))
    while engine.num_decoding < SLOTS:
        engine.step()
    for _ in range(2):                  # a capture (graph engines) and a warm step
        engine.step()
    st = engine.stats
    graphs = getattr(engine, "graphs", None)
    kind = "graph replay" if graphs is not None else "eager"

    # window 1, unprofiled: the wall, and each replay's span
    spans = []
    if graphs is not None:
        run = graphs.run

        def timed(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = run(*a, **k)
            end.record()
            spans.append((start, end))
            return out
        graphs.run = timed
    steps0, chunks0 = st.decode_steps, st.prefill_chunks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for _ in range(args.steps):
            engine.step()
        wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        if graphs is not None:
            del graphs.run                  # the bound method again
    torch.cuda.synchronize()
    steps = st.decode_steps - steps0

    # window 2, profiled: the device's busy time
    steps1 = st.decode_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    if st.prefill_chunks != chunks0 or st.decode_steps - steps1 != steps:
        raise AssertionError(f"the windows were not {args.steps} steady decode calls "
                             f"each: {st.prefill_chunks - chunks0} prefill chunks, "
                             f"steps {steps} / {st.decode_steps - steps1}")
    out = dict(kind=kind, horizon=args.horizon, calls=args.steps, steps=steps,
               wall_us_per_step=wall_us / steps, busy_us_per_step=busy_us / steps,
               idle_us_per_step=(wall_us - busy_us) / steps,
               idle_share=1 - busy_us / wall_us)
    if spans:
        span_us = sum(a.elapsed_time(b) for a, b in spans) * 1e3
        out.update(span_us_per_step=span_us / steps,
                   span_idle_us_per_step=(wall_us - span_us) / steps)
    print(f"decode_idle ({kind}, H = {args.horizon}): {steps} steps a window; wall "
          f"{out['wall_us_per_step']} us a step, device busy {out['busy_us_per_step']} "
          f"us a step (profiled window), idle {out['idle_us_per_step']} us a step "
          f"(share {out['idle_share']})"
          + (f"; replay span {out['span_us_per_step']} us a step (CUDA events), "
             f"idle beside it {out['span_idle_us_per_step']} us a step" if spans else ""))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
