"""Mesh builders of the port.

The counterpart of ``repro.launch.mesh``.  The reference's production
mesh is a fixed ``(16, 16)`` grid of 256 chips; the port builds the
``(data, model)`` grid over the cards that are visible, through
:func:`~repro_torch.distributed.elastic.best_mesh` with the reference's
model axis of 16 (one card: ``(1, 1)``; four: ``(1, 4)``).  Functions, not
module-level constants: importing this module touches no device.
"""

from __future__ import annotations

from repro_torch.distributed.elastic import Mesh, best_mesh, visible_devices

MODEL_PARALLEL = 16


def make_production_mesh(*, model_parallel: int = MODEL_PARALLEL) -> Mesh:
    """The (data, model) grid over the visible CUDA cards; raises without
    one."""
    devices = visible_devices()
    if devices == ["cpu"]:
        raise RuntimeError("the production mesh needs a CUDA card; pass "
                           "--smoke or --mesh with --device cpu")
    return best_mesh(devices, model_parallel=model_parallel)


def make_host_mesh(device: str = "cuda") -> Mesh:
    """The degenerate ``(1, 1)`` mesh over one local device (the launcher's
    ``--smoke`` run)."""
    return Mesh((device,), (1, 1))
