"""End-to-end driver: train a ~100M-param LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \\
        [--smoke] [--device cpu]

The counterpart of ``examples/train_lm.py``.  Uses a width-reduced qwen3
family config sized to ~100M params (``--smoke``: the reduced qwen3-8b
config), the synthetic data pipeline, AdamW with warmup-cosine,
checkpointing every 50 steps, and VPE enabled — during the run the
controller trials the flash-attention variant (``flash_cuda``) inside the
step and keeps whichever measures faster on this device.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Dict, List, Optional, Sequence

from ..configs import get_config
from ..configs.base import ModelConfig
from ..data import DataConfig, SyntheticStream
from ..runtime.train_loop import TrainLoop, TrainLoopConfig


def config_100m() -> ModelConfig:
    base = get_config("qwen3-8b")
    return dataclasses.replace(
        base,
        name="qwen3-100m",
        num_layers=6,
        d_model=640,
        num_heads=10,
        num_kv_heads=2,
        head_dim=64,
        d_ff=1792,
        vocab_size=32768,
        dtype="float32",
        remat="none",
    )


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Train as the flags say; returns the loop's metrics, one dict a
    step."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced qwen3-8b config instead of ~100M")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)

    cfg = get_config("qwen3-8b").reduced() if args.smoke else config_100m()
    n = cfg.param_count()
    print(f"model: {cfg.name}, {n / 1e6:.1f}M params")
    data = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="train_lm_")
    loop = TrainLoop(
        cfg,
        TrainLoopConfig(
            total_steps=args.steps, peak_lr=6e-4,
            warmup_steps=max(args.steps // 10, 1),
            checkpoint_every=50, checkpoint_dir=ckpt_dir,
            log_every=20, num_microbatches=2),
        data,
        seed=0,
        device=args.device,
    )
    metrics = loop.run()
    print(f"\nloss: {metrics[0]['loss']:.3f} -> {metrics[-1]['loss']:.3f} "
          f"over {len(metrics)} steps")
    print(f"checkpoints in {ckpt_dir}")
    print("\nVPE decisions made during training:")
    print(loop.vpe.report())
    return metrics


if __name__ == "__main__":
    main()
