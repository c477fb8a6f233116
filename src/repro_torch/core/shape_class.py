"""Shape-class bucketing — the paper's §5.2 "decision tree on input size".

Dispatch decisions are kept per (op, bucket), so the controller learns a
size-dependent policy without special-casing.  Every function here returns
the same keys as its ``repro.core.shape_class`` counterpart, so decision
tables of the two packages can be compared entry by entry.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

from torch.utils import _pytree as pytree


def _elements(x: Any) -> int:
    if hasattr(x, "shape"):
        n = 1
        for d in x.shape:
            n *= int(d)
        return n
    return 1


def shape_bucket(*args: Any, granularity: float = 1.0) -> Tuple:
    """Map call arguments to a hashable bucket key.

    granularity: bucket width in log2 units.  1.0 -> one bucket per
    power of two of total input elements.
    """
    total = 0
    ranks = []
    for leaf in pytree.tree_leaves(args):
        total += _elements(leaf)
        if hasattr(leaf, "shape"):
            ranks.append(len(leaf.shape))
    if total <= 0:
        return ("scalar",)
    b = int(math.floor(math.log2(total) / granularity))
    return (b, tuple(sorted(set(ranks))))


def bucket_label(bucket: Tuple) -> str:
    """Human-readable label of the bucket kinds this package produces."""
    if bucket == ("scalar",):
        return "scalar"
    if bucket and bucket[0] == "occ":
        _, level, total = bucket
        return f"occ{level}/{total}slots"
    if bucket and bucket[0] == "plen":
        _, b = bucket
        if b == 0:
            return "plen0"
        return f"plen[{2 ** (b - 1)},{2 ** b})tok"
    if bucket and bucket[0] == "pfc":
        _, pb, level, total = bucket
        plen = "plen0" if pb == 0 else f"plen[{2 ** (pb - 1)},{2 ** pb})"
        return f"chunk:{plen}xocc{level}/{total}slots"
    b, ranks = bucket
    lo, hi = 2 ** b, 2 ** (b + 1)
    return f"[{lo},{hi})elems/rank{','.join(map(str, ranks))}"


def occupancy_bucket(active: int, total: int, *, levels: int = 4) -> Tuple:
    """Dispatch key for the serve engine's decode step: slot occupancy
    quantized to ``levels`` levels (decode cost and the best attention
    layout depend on how many slots are live)."""
    if total <= 0 or active <= 0:
        return ("occ", 0, total)
    level = min(levels, max(1, math.ceil(active / total * levels)))
    return ("occ", level, total)


def prefix_len_bucket(matched: int) -> Tuple:
    """Log2 length bucket of a token count (0 = empty)."""
    if matched <= 0:
        return ("plen", 0)
    return ("plen", int(math.floor(math.log2(matched))) + 1)


def prefill_chunk_bucket(prompt_len: int, active: int, total: int, *,
                         levels: int = 4) -> Tuple:
    """Dispatch key for the serve engine's ``prefill_kernel`` axis:
    prompt-length bucket × occupancy level (the kernel crossover depends
    on how long the prompt is and how busy the pool already is)."""
    p = prefix_len_bucket(prompt_len)
    o = occupancy_bucket(active, total, levels=levels)
    return ("pfc", p[1], o[1], total)


def pad_to_bucket(n: int, *, minimum: int = 16) -> int:
    """Next power of two >= n (floored at ``minimum``): prompt chunks are
    padded to these sizes, so the kernels see few distinct shapes."""
    if n <= minimum:
        return minimum
    return 1 << math.ceil(math.log2(n))
