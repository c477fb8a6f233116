"""Random weights made from the seed, on the device, in the dtype served.

Both sides of a run take their weights from here: the program gets them
once in set-up, and the plain reference makes the same numbers again after
the window, from the same seed, so it takes nothing the program made.  Each
leaf (a stack over the layers, in the port's parameter layout, as the
configuration's family lists them) is one ``torch.randn`` call on a
generator of its own, seeded from ``--seed`` and the leaf's index, so any
leaf can be made again alone.  A leaf is made in the dtype served, or in
the dtype its family pins (an MoE router's f32).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import families

# (path, shape, init, dtype) in the port's layout: "normal" is N(0, 1 /
# fan_in) (the port's dense_init), "embed" N(0, 0.02^2), "ones" a norm gain;
# dtype None is the dtype served
Spec = Tuple[str, Tuple[int, ...], str, Optional[str]]


def leaf_specs(d) -> List[Spec]:
    """Every leaf of the model ``d`` describes, from its family
    (``families/<family>.py``): ``(path, shape, init, dtype)``."""
    return families.program(d.family).leaf_specs(d)


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for leaf ``index`` of run ``seed`` (any
    whole number, negative or past 64 bits included)."""
    ss = np.random.SeedSequence([abs(int(seed)) % (1 << 128), int(seed < 0), index, 0x57])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_leaf(spec: Spec, seed: int, index: int, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    path, shape, init, leaf_dtype = spec
    if leaf_dtype is not None:
        dtype = getattr(torch, leaf_dtype)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, index))
    w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    std = 0.02 if init == "embed" else 1.0 / math.sqrt(shape[-2])
    return w.mul_(std)


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{"a": t, "layers/b": u}`` -> ``{"a": t, "layers": {"b": u}}``."""
    out: Dict = {}
    for path, leaf in flat.items():
        head, _, tail = path.partition("/")
        if tail:
            out.setdefault(head, {})[tail] = leaf
        else:
            out[head] = leaf
    return out


def flatten(tree: Dict) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`nest`."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{k2}": v2 for k2, v2 in v.items()})
        else:
            flat[k] = v
    return flat


def make_params(cfg, seed: int, device: torch.device,
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The whole parameter tree, in the port's layout."""
    return nest({spec[0]: make_leaf(spec, seed, i, device, dtype)
                 for i, spec in enumerate(leaf_specs(cfg))})


def remake(cfg, seed: int, path: str, device: torch.device,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Leaf ``path`` of :func:`make_params` made again alone."""
    for i, spec in enumerate(leaf_specs(cfg)):
        if spec[0] == path:
            return make_leaf(spec, seed, i, device, dtype)
    raise KeyError(path)
