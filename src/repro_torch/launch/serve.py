"""Serving launcher of the port: the wave scheduler, or continuous batching.

    python -m repro_torch.launch.serve --arch qwen3-8b [--smoke] [--device cpu]
    python -m repro_torch.launch.serve --arch qwen3-8b [--smoke] --continuous \\
        [--kv-layout contiguous|paged|auto] [--prefix-cache --prefix-blocks 64] \\
        [--prefill-chunk 128|whole|auto] [--decode-horizon 16|auto] \\
        [--decode-impl cuda --prefill-kernel cuda] [--spec-draft 4|auto] \\
        [--priority mix --page-budget 11 --swap --slo-weight 0.5] \\
        [--watchdog --fault-seed 5 --fault-storm 8 --deadline 30 \\
         --max-queue-depth 16] [--mesh 2,1 --device cuda:0,cuda:0] \\
        [--mesh 1,2 --device cpu,cpu] [--device cpu]

Without ``--continuous`` requests run in waves (``ServeLoop`` +
``WaveScheduler``, the baseline), the only path of the recurrent and
hybrid archs (rwkv6-7b, zamba2-1.2b): ``--continuous`` refuses them, as
the reference's engine does.  The flags are those of
``repro.launch.serve``.  ``--mesh DP,1`` (continuous only) serves DP
engine replicas behind one shared admission queue on the devices that
``--device`` lists, one a replica (``cuda:0,cuda:0``: two replicas on one
card; ``cpu,cpu``: on the CPU; a bare ``cuda`` takes ``cuda:0`` …
``cuda:{DP*MP-1}``).  ``--mesh DP,MP`` with ``MP > 1`` shards each
engine's heads over MP processes (``spawn_ranks``) on the DP*MP devices
of ``--device``, row-major (``cpu,cpu`` or ``cuda:0,cuda:0`` for ``1,2``:
two ranks on the CPU or on one card, over ``gloo``): every rank draws the
same weights and requests from ``--seed``, and rank 0's lines are
printed.  An encdec arch
(whisper-base) is refused: its prefill needs frames, and neither this
launcher nor the reference's has a source of them (serve it through
``ServeLoop.generate`` with {"tokens", "frames"}).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import VPE
from repro_torch.distributed.group import shard_backend, spawn_ranks
from repro_torch.models import model as model_lib
from repro_torch.runtime.serve_faults import FaultPlan
from repro_torch.runtime.serve_loop import (SERVE_AXES, Request, ServeLoop,
                                            WaveScheduler, make_serve_engine)

NO_FRAMES = ("{arch} needs frame embeddings and this launcher has no source "
             "of them (nor has the reference's); call ServeLoop.generate "
             "with {{'tokens', 'frames'}} or model.loss_fn with a 'frames' "
             "batch")


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
    ap.add_argument("--mesh", default="1,1", metavar="DP,MP",
                    help="serve mesh 'dp,mp' (continuous only): dp runs "
                         "independent engine replicas behind one shared "
                         "admission queue, on the devices --device lists; "
                         "'1,1' (default) is the single engine; mp > 1 "
                         "shards each engine's heads over mp processes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path; "
                         "with --mesh, a comma list of dp*mp devices (one "
                         "may repeat: cuda:0,cuda:0), or a bare cuda for "
                         "cuda:0 .. cuda:{dp*mp-1}")
    args = ap.parse_args(argv)
    try:
        dp, mp = (int(x) for x in args.mesh.split(","))
    except ValueError:
        ap.error(f"--mesh must be 'dp,mp' integers, got {args.mesh!r}")
    if dp < 1 or mp < 1:
        ap.error(f"--mesh axes must be >= 1, got {args.mesh!r}")
    if (dp, mp) != (1, 1) and not args.continuous:
        ap.error("--mesh requires --continuous")
    devices = args.device.split(",")
    if dp * mp == 1 and len(devices) != 1:
        ap.error(f"--device names {len(devices)} devices for one engine")
    # a bare "cuda" leaves a group's placement to its default
    mesh_devices = (None if (dp, mp) == (1, 1) or devices == ["cuda"]
                    else devices)
    if mesh_devices is not None and len(mesh_devices) != dp * mp:
        ap.error(f"--mesh {dp},{mp} needs {dp * mp} devices in --device, "
                 f"got {len(mesh_devices)}")
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

    cfg = get_config(args.arch)
    if cfg.family == "encdec":
        ap.error(NO_FRAMES.format(arch=args.arch))
    if args.smoke:
        cfg = cfg.reduced()
    run = (args, cfg, (dp, mp), mesh_devices, horizon, chunk, spec)
    if mp == 1:
        lines = _serve(None, *run)
    else:
        # one process a shard: rank r's current device is column r of the
        # mesh; the replicas of a rank (dp > 1) share one communicator,
        # which is gloo's
        devs = mesh_devices or [f"cuda:{i}" for i in range(dp * mp)]
        lines = spawn_ranks(_serve, devs[:mp], run,
                            backend=shard_backend(devs[:mp]) if dp == 1 else "gloo")[0]
    print("\n".join(lines))


def _serve(group, args, cfg, mesh, mesh_devices, horizon, chunk, spec):
    """Serve the seeded requests (on rank ``group.rank`` of a head-sharded
    mesh, or alone when ``group`` is None) and return the report's lines
    (rank 0's; another rank returns none).  The params are made on the
    rank's first device, from the seed: every rank draws the same; a
    replica on another device gets a copy."""
    dp, mp = mesh
    rank = group.rank if group is not None else 0
    devices = args.device.split(",")
    device = resolve_device(mesh_devices[rank] if mesh_devices else
                            f"cuda:{rank}" if mp > 1 else devices[0])
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
        return [f"completed {len(done)} requests; decode throughput "
                f"{st.decode_tok_per_s:.1f} tok/s (prefill {st.prefill_s:.2f}s, "
                f"decode {st.decode_s:.2f}s)"]
    vpe = VPE()
    plan = (FaultPlan.seeded(args.fault_seed, args.fault_storm, slots=args.batch)
            if args.fault_seed is not None else None)
    place = ({"mesh_devices": mesh_devices, "shard_group": group}
             if mesh != (1, 1) else {"device": device})
    engine = make_serve_engine(
        cfg, params, mesh_shape=mesh,
        slots=args.batch, max_len=args.max_len, vpe=vpe,
        prefix_blocks=args.prefix_blocks if args.prefix_cache else 0,
        block_size=args.block_size, kv_layout=args.kv_layout,
        prefill_chunk=chunk, chunks_per_step=args.chunks_per_step,
        decode_horizon=horizon, decode_impl=args.decode_impl,
        prefill_kernel=args.prefill_kernel, spec_draft=spec,
        page_budget=args.page_budget, swap=args.swap,
        slo_weight=args.slo_weight, fault_plan=plan, watchdog=args.watchdog,
        max_queue_depth=args.max_queue_depth, **place)
    del params                  # a rank keeps its shard only
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    if rank != 0:
        return []
    stats = engine.stats
    mesh_note = f" [mesh {dp}x{mp}]" if mesh != (1, 1) else ""
    lines = [f"completed {len(done)} requests{mesh_note}; {stats.summary()}"]
    if plan is not None:
        fired = ", ".join(f"{f.site}/{f.kind}@{f.at}"
                          for f in plan.injected) or "none"
        lines.append(f"fault storm (seed {args.fault_seed}): "
                     f"{len(plan.injected)}/{len(plan)} fired [{fired}]")
    if stats.spec_calls:
        hist = ", ".join(f"{k}:{v}" for k, v in sorted(stats.accept_hist.items()))
        lines.append(f"spec accept histogram (drafts accepted -> slot-calls): {hist}")
    # which variant each measured axis settled on, and the trials behind it
    lines.append(vpe.report())
    return lines


if __name__ == "__main__":
    main()
