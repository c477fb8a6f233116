"""Fault injection and the training loop's recovery.

The counterpart of the training half of ``repro.runtime.fault``.  A
fenced step raises on device loss (tests inject :class:`SimulatedFault`
through ``TrainLoop.fault_hook``); the durable state is the checkpoint, so
recovery is restore-and-replay:

1. a late step (straggler) is handled inside the loop
   (``runtime/train_loop.py``; on a mesh rank 0's verdict, on every rank);
2. restore the latest checkpoint on the same device or mesh (host
   restart) — :func:`run_with_recovery`, which on a mesh runs on every
   rank: a fault raised at the same step on all of them restores all of
   them together;
3. elastic restore — :func:`respawn_elastic`: the ranks are started anew
   on :func:`~repro_torch.distributed.elastic.best_mesh` of the surviving
   devices, and each restores its shard of the whole checkpoint.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence


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


def respawn_elastic(fn: Callable, survivors: Sequence[Any], args: tuple = (), *,
                    lost: int = 0, model_parallel: int = 16,
                    timeout_s: Optional[float] = None) -> List[Any]:
    """Rung 3: run ``fn(group, mesh_shape, *args)`` on every rank of
    ``best_mesh(survivors, model_parallel=...)``, one process a rank
    (``spawn_ranks``), and return the results by rank.  ``fn`` builds its
    ``TrainLoop`` on the new mesh and restores the checkpoint (the whole
    tree, whatever mesh wrote it).  ``lost`` devices are named in the
    plan's log line."""
    from repro_torch.distributed import elastic
    from repro_torch.distributed.group import DEFAULT_TIMEOUT_S, spawn_ranks
    mesh = elastic.best_mesh(survivors, model_parallel=model_parallel)
    print(elastic.shrink_plan(len(survivors) + lost, len(survivors), model_parallel))
    return spawn_ranks(fn, mesh.devices, (mesh.shape, *args),
                       timeout_s=timeout_s or DEFAULT_TIMEOUT_S)
