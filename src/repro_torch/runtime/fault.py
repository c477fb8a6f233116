"""Fault injection and the training loop's recovery.

The counterpart of the training half of ``repro.runtime.fault``.  A
fenced step raises on device loss (tests inject :class:`SimulatedFault`
through ``TrainLoop.fault_hook``); the durable state is the checkpoint, so
recovery is restore-and-replay:

1. a late step (straggler) is handled inside the loop
   (``runtime/train_loop.py``);
2. restore the latest checkpoint on the same device (host restart) —
   :func:`run_with_recovery`.

Rung 3 of the reference, the elastic restore onto a shrunk mesh, waits
for the port's mesh (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

from typing import Callable, Optional


class SimulatedFault(RuntimeError):
    """Injected by tests to stand in for a device/host loss."""


def run_with_recovery(
    loop,
    num_steps: int,
    *,
    max_restores: int = 3,
    on_restore: Optional[Callable[[int], None]] = None,
) -> int:
    """Run ``loop`` to ``num_steps``, restoring from checkpoint on faults.

    ``loop`` is duck-typed: anything with an integer ``step`` attribute,
    a ``run(num_steps)`` that raises :class:`SimulatedFault` on device
    loss, and a ``restore() -> bool`` that rewinds to the latest
    checkpoint (the TrainLoop surface).

    Returns the number of restores performed.  Raises if recovery is
    exhausted or no checkpoint exists when one is needed.
    """
    restores = 0
    while loop.step < num_steps:
        try:
            loop.run(num_steps)
        except SimulatedFault:
            if restores >= max_restores:
                raise
            restores += 1
            if on_restore is not None:
                on_restore(restores)
            if not loop.restore():
                raise RuntimeError("fault before first checkpoint — cannot recover")
    return restores
