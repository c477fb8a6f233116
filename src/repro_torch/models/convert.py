"""Parameters of the JAX reference, converted for the port.

The parity tests hand ``repro``'s ``init_params`` tree over as numpy
arrays (``np.asarray`` of each leaf); :func:`params_from_jax` turns it
into the port's parameter dict on ``device``.  The layout and the
``(d_in, d_out)`` weight orientation are the same on both sides, so the
conversion only changes the container.  bfloat16 leaves (numpy's
``ml_dtypes`` bfloat16) go through float32, which is exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


def _leaf(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_jax(tree: Any, device: DeviceLike = "cuda") -> Any:
    """Nested dicts of arrays -> the same nesting of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return _leaf(tree, dev)
