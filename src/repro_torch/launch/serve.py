"""Serving launcher of the port: the wave scheduler, or continuous batching.

    python -m repro_torch.launch.serve --arch qwen3-8b [--smoke] [--device cpu]
    python -m repro_torch.launch.serve --arch qwen3-8b [--smoke] --continuous \\
        [--kv-layout contiguous|paged|auto] [--prefix-cache --prefix-blocks 64] \\
        [--prefill-chunk 128|whole|auto] [--decode-horizon 16|auto] \\
        [--decode-impl cuda --prefill-kernel cuda] [--spec-draft 4|auto] \\
        [--priority mix --page-budget 11 --swap --slo-weight 0.5] \\
        [--watchdog --fault-seed 5 --fault-storm 8 --deadline 30 \\
         --max-queue-depth 16] [--device cpu]

Without ``--continuous`` requests run in waves (``ServeLoop`` +
``WaveScheduler``, the baseline).  The flags are those of
``repro.launch.serve``; ``--mesh``, whose replicas and shards are not
ported, is rejected with the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import VPE
from repro_torch.models import model as model_lib
from repro_torch.runtime.serve_faults import FaultPlan
from repro_torch.runtime.serve_loop import (LATER, SERVE_AXES,
                                            ContinuousBatchingEngine, Request,
                                            ServeLoop, WaveScheduler)

# flags of repro.launch.serve outside the port -> ROADMAP item
_LATER_FLAGS = {"--mesh": "mesh"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="run the reduced (smoke) config of the arch")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="token-level continuous batching (default: waves)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree shared-prefix KV cache (continuous only)")
    ap.add_argument("--prefix-blocks", type=int, default=64,
                    help="cached-prefix page headroom for --prefix-cache")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--kv-layout", choices=["contiguous", "paged", "auto"],
                    default="contiguous",
                    help="slot KV layout: contiguous per-slot regions, paged "
                         "block tables over the unified page pool, or auto "
                         "(a VPE axis per matched-length x occupancy bucket)")
    ap.add_argument("--prefill-chunk", default="whole",
                    help="prefill chunk size in tokens of paged admissions, "
                         "'whole' (one chunk a prompt), or 'auto' — a VPE "
                         "axis over whole, 128, 512 and 2048 keyed by "
                         "prompt length x occupancy")
    ap.add_argument("--chunks-per-step", type=int, default=None)
    ap.add_argument("--decode-horizon", default="1",
                    help="decode steps fused into one device call per "
                         "engine step (int), or 'auto' — a VPE axis keyed "
                         "by queue depth x occupancy, fed from per-token "
                         "walls")
    ap.add_argument("--decode-impl",
                    choices=SERVE_AXES["serve_decode_impl"] + ["auto"],
                    default="auto",
                    help="decode attention: the contiguous cache or "
                         "gathered pages (grouped/flat), the CUDA paged-"
                         "decode kernel (cuda; grouped on a contiguous "
                         "cache), or the measured VPE axis (auto)")
    ap.add_argument("--prefill-kernel",
                    choices=SERVE_AXES["prefill_kernel"] + ["auto"],
                    default="auto",
                    help="chunked-prefill attention: gathered pages "
                         "(gather), the CUDA kernel (cuda), or auto")
    ap.add_argument("--priority", choices=["batch", "interactive", "mix"],
                    default="batch",
                    help="request priority class; 'mix' alternates "
                         "interactive and batch")
    ap.add_argument("--page-budget", type=int, default=None,
                    help="pages of the paged pool, below the worst case: "
                         "exhaustion is recovered by eviction and "
                         "preemption (at least max_len/block_size + 2)")
    ap.add_argument("--swap", action="store_true",
                    help="resume preempted requests from their K/V copied "
                         "to host memory instead of recomputing it")
    ap.add_argument("--slo-weight", type=float, default=0.0,
                    help="weight of the queue-wait term: fused horizons and "
                         "prefill chunks are charged wall x (1 + w x "
                         "class-weighted queued requests); 0 turns it off")
    ap.add_argument("--spec-draft", default="off",
                    help="speculative verify span: 'off', an int S (one pass "
                         "scores the last token and S-1 n-gram drafts), or "
                         "'auto' — a VPE axis keyed by queue depth x "
                         "occupancy x measured acceptance; the contiguous "
                         "layout and --decode-horizon 1 resolve it to 'off'")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-request deadline in seconds from submit; an "
                         "expired request is shed (queued or resident) with "
                         "reason code 'deadline'")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="admission bound: submissions beyond this queue "
                         "depth fail at once with reason code 'capacity' "
                         "(continuous only)")
    ap.add_argument("--watchdog", action="store_true",
                    help="guard each decode span's fence with the straggler "
                         "watchdog: a stalled fence commits its late tokens "
                         "and demotes the span's variant")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="inject a reproducible fault storm seeded here "
                         "(device errors, poisoned logits, fence stalls at "
                         "planned span coordinates); the engine recovers "
                         "through its ladder and the last lines list the "
                         "faults that fired")
    ap.add_argument("--fault-storm", type=int, default=8, metavar="N",
                    help="number of faults in the --fault-seed storm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    args, unknown = ap.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=")[0]
        if flag in _LATER_FLAGS:
            ap.error(f"{flag} is not ported yet: ROADMAP queue 1, item "
                     f"{LATER[_LATER_FLAGS[flag]]}")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    try:
        horizon = (args.decode_horizon if args.decode_horizon == "auto"
                   else int(args.decode_horizon))
    except ValueError:
        ap.error(f"--decode-horizon must be a step count or 'auto', got "
                 f"{args.decode_horizon!r}")
    chunk = (args.prefill_chunk if args.prefill_chunk in ("whole", "auto")
             else int(args.prefill_chunk))
    try:
        spec = (args.spec_draft if args.spec_draft in ("off", "auto")
                else int(args.spec_draft))
    except ValueError:
        ap.error(f"--spec-draft must be 'off', a span or 'auto', got "
                 f"{args.spec_draft!r}")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = model_lib.init_params(
        cfg, torch.Generator(device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)

    def _prio(i: int) -> str:
        if args.priority == "mix":
            return "interactive" if i % 2 == 0 else "batch"
        return args.priority

    reqs = [Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
        max_new_tokens=args.new_tokens, priority=_prio(i),
        deadline_s=args.deadline)
        for i in range(args.requests)]
    if not args.continuous:
        serve = ServeLoop(cfg, params, max_len=args.max_len, batch=args.batch,
                          device=device)
        sched = WaveScheduler(serve)
        for r in reqs:
            sched.submit(r)
        done = sched.run()
        st = serve.stats
        print(f"completed {len(done)} requests; decode throughput "
              f"{st.decode_tok_per_s:.1f} tok/s (prefill {st.prefill_s:.2f}s, "
              f"decode {st.decode_s:.2f}s)")
        return
    vpe = VPE()
    plan = (FaultPlan.seeded(args.fault_seed, args.fault_storm, slots=args.batch)
            if args.fault_seed is not None else None)
    engine = ContinuousBatchingEngine(
        cfg, params, slots=args.batch, max_len=args.max_len, vpe=vpe,
        prefix_blocks=args.prefix_blocks if args.prefix_cache else 0,
        block_size=args.block_size, kv_layout=args.kv_layout,
        prefill_chunk=chunk, chunks_per_step=args.chunks_per_step,
        decode_horizon=horizon, decode_impl=args.decode_impl,
        prefill_kernel=args.prefill_kernel, spec_draft=spec,
        page_budget=args.page_budget, swap=args.swap,
        slo_weight=args.slo_weight, fault_plan=plan, watchdog=args.watchdog,
        max_queue_depth=args.max_queue_depth, device=device)
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    stats = engine.stats
    print(f"completed {len(done)} requests; {stats.summary()}")
    if plan is not None:
        fired = ", ".join(f"{f.site}/{f.kind}@{f.at}"
                          for f in plan.injected) or "none"
        print(f"fault storm (seed {args.fault_seed}): "
              f"{len(plan.injected)}/{len(plan)} fired [{fired}]")
    if stats.spec_calls:
        hist = ", ".join(f"{k}:{v}" for k, v in sorted(stats.accept_hist.items()))
        print(f"spec accept histogram (drafts accepted -> slot-calls): {hist}")
    # which variant each measured axis settled on, and the trials behind it
    print(vpe.report())


if __name__ == "__main__":
    main()
