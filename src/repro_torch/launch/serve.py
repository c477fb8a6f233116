"""Serving launcher of the port: continuous batching over the paged KV layout.

    python -m repro_torch.launch.serve --arch qwen3-8b [--smoke] \\
        --continuous --kv-layout paged [--prefill-chunk 128] \\
        [--decode-horizon 16|auto] [--decode-impl cuda --prefill-kernel cuda] \\
        [--device cpu]

The flags are those of ``repro.launch.serve`` for the subset this slice
ports; the others are rejected with the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import VPE
from repro_torch.models import model as model_lib
from repro_torch.runtime.serve_loop import (LATER, SERVE_AXES,
                                            ContinuousBatchingEngine, Request)

# flags of repro.launch.serve outside this slice -> ROADMAP item
_LATER_FLAGS = {
    "--prefix-cache": "prefix_cache", "--prefix-blocks": "prefix_cache",
    "--spec-draft": "speculation",
    "--priority": "preemption", "--page-budget": "preemption",
    "--swap": "preemption", "--slo-weight": "preemption",
    "--deadline": "faults", "--max-queue-depth": "faults",
    "--watchdog": "faults", "--fault-seed": "faults",
    "--fault-storm": "faults", "--mesh": "mesh",
}


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
                    help="token-level continuous batching (required: the "
                         "wave scheduler is not ported yet)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--kv-layout", choices=["contiguous", "paged", "auto"],
                    default="paged")
    ap.add_argument("--prefill-chunk", default="whole",
                    help="prefill chunk size in tokens, or 'whole'")
    ap.add_argument("--chunks-per-step", type=int, default=None)
    ap.add_argument("--decode-horizon", default="1",
                    help="decode steps fused into one device call per "
                         "engine step (int), or 'auto' — a VPE axis keyed "
                         "by queue depth x occupancy, fed from per-token "
                         "walls")
    ap.add_argument("--decode-impl",
                    choices=SERVE_AXES["serve_decode_impl"] + ["auto"],
                    default="auto",
                    help="decode attention: gathered pages (grouped/flat), "
                         "the CUDA paged-decode kernel (cuda), or the "
                         "measured VPE axis (auto)")
    ap.add_argument("--prefill-kernel",
                    choices=SERVE_AXES["prefill_kernel"] + ["auto"],
                    default="auto",
                    help="chunked-prefill attention: gathered pages "
                         "(gather), the CUDA kernel (cuda), or auto")
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
    if not args.continuous:
        ap.error("the wave scheduler is not ported yet (ROADMAP queue 1, "
                 f"item {LATER['contiguous']}): pass --continuous")
    if args.kv_layout != "paged":
        item = "contiguous" if args.kv_layout == "contiguous" else "auto_layout"
        ap.error(f"--kv-layout {args.kv_layout} is not ported yet: ROADMAP "
                 f"queue 1, item {LATER[item]}")
    try:
        horizon = (args.decode_horizon if args.decode_horizon == "auto"
                   else int(args.decode_horizon))
    except ValueError:
        ap.error(f"--decode-horizon must be a step count or 'auto', got "
                 f"{args.decode_horizon!r}")
    chunk = ("whole" if args.prefill_chunk == "whole"
             else int(args.prefill_chunk))

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = model_lib.init_params(
        cfg, torch.Generator(device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    reqs = [Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
        max_new_tokens=args.new_tokens)
        for i in range(args.requests)]
    vpe = VPE()
    engine = ContinuousBatchingEngine(
        cfg, params, slots=args.batch, max_len=args.max_len, vpe=vpe,
        block_size=args.block_size, prefill_chunk=chunk,
        chunks_per_step=args.chunks_per_step, decode_horizon=horizon,
        decode_impl=args.decode_impl,
        prefill_kernel=args.prefill_kernel, device=device)
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    print(f"completed {len(done)} requests; {engine.stats.summary()}")
    # which variant each measured axis settled on, and the trials behind it
    print(vpe.report())


if __name__ == "__main__":
    main()
