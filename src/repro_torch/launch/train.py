"""Training launcher of the port.

    python -m repro_torch.launch.train --arch h2o-danube-3-4b \\
        --steps 8 --batch 1 --seq 4096 [--ckpt DIR] [--device cuda]
    python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
        --steps 4 --batch 4 --seq 32 --device cpu

The flags are those of ``repro.launch.train``.  ``--smoke`` trains the
reduced config; without it the full config is trained on one device (the
port has no production mesh yet: ROADMAP queue 1, item 10).  The VPE
trials the attention implementations (``reference``, ``flash_cuda``)
inside the loop unless ``--no-vpe``; its decision table is printed at the
end.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--no-vpe", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernel versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    data = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, peak_lr=args.lr,
        warmup_steps=max(args.steps // 10, 1),
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt,
        num_microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        enable_vpe=not args.no_vpe,
        log_every=max(args.steps // 20, 1),
    )
    loop = TrainLoop(cfg, loop_cfg, data, seed=args.seed, device=args.device)
    if args.resume and loop.restore():
        print(f"resumed from step {loop.step}")
    metrics = loop.run()
    print(f"done: {loop.step} steps; "
          f"loss {metrics[0]['loss']:.4f} -> {metrics[-1]['loss']:.4f}")
    print(loop.vpe.report())
    if args.ckpt:
        loop.save()


if __name__ == "__main__":
    main()
