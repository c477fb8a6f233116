"""LR schedules: pure functions of the step, returning a Python float (the
counterpart of ``repro.optim.schedule``)."""

from __future__ import annotations

import math


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> float:
    step = float(step)
    if step < warmup_steps:
        return peak_lr * step / max(warmup_steps, 1)
    frac = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
    return peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))


def constant(step, *, peak_lr: float) -> float:
    return float(peak_lr)
