"""Elastic scaling: rebuild the mesh from whatever devices survive.

The counterpart of ``repro.distributed.elastic``.  The controller that
sees devices lost calls :func:`best_mesh` for the largest usable
``(data, model)`` grid over the survivors, re-spawns one process a rank on
it (:func:`repro_torch.runtime.fault.respawn_elastic`), and each rank
restores the last checkpoint, which is the whole tree whatever mesh wrote
it, keeping its own shard leaf by leaf from the files
(``TrainLoop.restore`` through ``MeshShard.cuts``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid: ``devices`` row-major, one a rank (rank
    ``r`` at ``divmod(r, shape[1])``, the reference's ``reshape``)."""
    devices: Tuple[str, ...]
    shape: Tuple[int, int]


def visible_devices() -> List[str]:
    """The visible CUDA cards, or the CPU when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [f"cuda:{i}" for i in range(n)] or ["cpu"]


def _model_axis(n: int, model_parallel: int) -> int:
    mp = min(model_parallel, n)
    while mp > 1 and n % mp != 0:
        mp -= 1
    return mp


def best_mesh(devices: Optional[Sequence[Any]] = None, *,
              model_parallel: int = 16) -> Mesh:
    """Largest (data, model) grid from the available devices.

    Keeps the model axis at the requested degree when possible (weights
    must still fit a device), shrinking the data axis: losing a host costs
    batch, not layout."""
    devices = [str(d) for d in (devices if devices is not None else visible_devices())]
    n = len(devices)
    mp = _model_axis(n, model_parallel)
    dp = n // mp
    return Mesh(tuple(devices[:dp * mp]), (dp, mp))


def shrink_plan(old_n: int, new_n: int, model_parallel: int) -> str:
    """Human-readable description of the elastic transition (for logs)."""
    mp = _model_axis(new_n, model_parallel)
    return (
        f"elastic: {old_n} -> {new_n} devices; "
        f"new grid data={new_n // mp} x model={mp}; "
        f"global batch rescaled by {new_n / old_n:.2f}"
    )
