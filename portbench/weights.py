"""Random weights made from the seed, on the device, in the dtype served.

Both sides of a run take their weights from here: the program gets them
once in set-up, and the plain reference makes the same numbers again after
the window, from the same seed, so it takes nothing the program made.  Each
leaf (a stack over the layers, in the port's parameter layout) is one
``torch.randn`` call on a generator of its own, seeded from ``--seed`` and
the leaf's index, so any leaf can be made again alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# (path, shape function, init) in the port's layout: "normal" is N(0, 1 /
# fan_in) (the port's dense_init), "embed" N(0, 0.02^2), "ones" a norm gain
Spec = Tuple[str, Tuple[int, ...], str]


def leaf_specs(cfg) -> List[Spec]:
    """Every leaf of a dense transformer in the port's layout: top-level
    leaves, and the per-layer weights stacked on a leading L axis under
    ``layers/``."""
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs: List[Spec] = [
        ("embed", (cfg.vocab_size, d), "embed"),
        ("final_norm", (d,), "ones"),
        ("layers/ln1", (L, d), "ones"),
        ("layers/ln2", (L, d), "ones"),
        ("layers/attn_wq", (L, d, hq * hd), "normal"),
        ("layers/attn_wk", (L, d, hkv * hd), "normal"),
        ("layers/attn_wv", (L, d, hkv * hd), "normal"),
        ("layers/attn_wo", (L, hq * hd, d), "normal"),
    ]
    if cfg.qkv_bias:
        raise ValueError("qkv_bias is not part of any configuration here")
    if cfg.qk_norm:
        specs += [("layers/attn_q_norm", (L, hd), "ones"),
                  ("layers/attn_k_norm", (L, hd), "ones")]
    specs += [("layers/ffn_w_gate", (L, d, f), "normal"),
              ("layers/ffn_w_up", (L, d, f), "normal"),
              ("layers/ffn_w_down", (L, f, d), "normal")]
    if not cfg.tie_embeddings:
        specs.append(("lm_head", (d, cfg.vocab_size), "normal"))
    return specs


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for leaf ``index`` of run ``seed`` (any
    whole number, negative or past 64 bits included)."""
    ss = np.random.SeedSequence([abs(int(seed)) % (1 << 128), int(seed < 0), index, 0x57])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_leaf(spec: Spec, seed: int, index: int, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    path, shape, init = spec
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
