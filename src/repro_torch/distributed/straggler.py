"""Straggler / hang mitigation.

The counterpart of ``repro.distributed.straggler``.  A straggling step
shows up as one step's fence taking far longer than the trailing mean.
:class:`StepWatchdog` wraps the fence with a timeout derived from an EWMA
of recent step times; on trip it raises :class:`StragglerTimeout`, which
the training loop handles (``runtime/train_loop.py``).  Contract: ``guard``
increments :attr:`trips` *itself* before raising — callers count trips in
their own stats, never on the watchdog.  By the time ``guard`` raises,
the fence has drained, so the step's work is done.

The watchdog is pure host code, so tests drive it with an injected
clock/fence; on the card it wraps the real fence
(:func:`repro_torch.core.dispatch.block_until_ready`, a
``torch.cuda.synchronize`` of every device the value lives on).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.core.dispatch import block_until_ready


class StragglerTimeout(RuntimeError):
    def __init__(self, elapsed: float, budget: float):
        super().__init__(f"step exceeded straggler budget: {elapsed:.3f}s > {budget:.3f}s")
        self.elapsed = elapsed
        self.budget = budget


class StepWatchdog:
    def __init__(
        self,
        *,
        multiplier: float = 5.0,
        min_budget_s: float = 1.0,
        ewma: float = 0.9,
        clock: Callable[[], float] = time.perf_counter,
        fence: Callable = block_until_ready,
    ) -> None:
        self.multiplier = multiplier
        self.min_budget_s = min_budget_s
        self.ewma = ewma
        self.clock = clock
        self.fence = fence
        self.mean_s: Optional[float] = None
        self.trips = 0

    @property
    def budget_s(self) -> float:
        if self.mean_s is None:
            return float("inf")  # no baseline yet — the first step warms up
        return max(self.min_budget_s, self.multiplier * self.mean_s)

    def guard(self, value):
        """Fence ``value``; record timing; raise on straggle."""
        t0 = self.clock()
        out = self.fence(value)
        dt = self.clock() - t0
        budget = self.budget_s
        if dt > budget:
            self.trips += 1
            raise StragglerTimeout(dt, budget)
        if self.mean_s is None:
            self.mean_s = dt
        else:
            self.mean_s = self.ewma * self.mean_s + (1 - self.ewma) * dt
        return out
