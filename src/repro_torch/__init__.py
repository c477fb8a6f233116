"""PyTorch + CUDA port of the ``repro`` serving runtime (NVIDIA Hopper).

The JAX package ``repro`` is the reference this package is held against
(the ``tests/test_torch_*.py`` parity suites run both side by side); this
package imports neither JAX nor anything of ``repro``.  Module names mirror
``repro``'s, so ``repro_torch.models.kvcache`` is the counterpart of
``repro.models.kvcache``.

Entry points take an explicit ``device`` and default to ``"cuda"``; without
a CUDA device they raise instead of moving to the CPU.  Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels (what the
CPU tests do).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def fence(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (no-op on the CPU, whose ops
    run synchronously) — the counterpart of ``jax.block_until_ready``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
