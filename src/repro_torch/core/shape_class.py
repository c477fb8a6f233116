"""Shape-class bucketing — the paper's §5.2 "decision tree on input size".

Dispatch decisions are kept per (op, bucket), so the controller learns a
size-dependent policy without special-casing.  Every function here returns
the same keys as its ``repro.core.shape_class`` counterpart, so decision
tables of the two packages can be compared entry by entry.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

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


def _split_slo(bucket: Tuple) -> Tuple[Tuple, Optional[Tuple]]:
    """Split a trailing :func:`slo_pressure_bucket` segment off a composite
    dispatch key (the serve engine appends it to the ``decode_horizon``,
    ``prefill_chunk`` and ``prefill_kernel`` keys when ``slo_weight`` > 0)."""
    if len(bucket) >= 4 and bucket[-3] == "slo":
        return bucket[:-3], bucket[-3:]
    return bucket, None


def _split_shard(bucket: Tuple) -> Tuple[Tuple, Optional[Tuple]]:
    """Split a trailing :func:`shard_bucket` segment off a composite
    dispatch key.  The serve engine appends it LAST (after any SLO
    segment) on non-trivial meshes, so it is stripped first here."""
    if len(bucket) >= 4 and bucket[-3] == "shard":
        return bucket[:-3], bucket[-3:]
    return bucket, None


def bucket_label(bucket: Tuple) -> str:
    """Human-readable label of the bucket kinds this package produces."""
    bucket, shard = _split_shard(bucket)
    bucket, slo = _split_slo(bucket)
    suffix = ""
    if slo is not None:
        _, i, b = slo
        suffix = f"xslo:i{i}b{b}"
    if shard is not None:
        _, dp, mp = shard
        suffix += f"xmesh:dp{dp}mp{mp}"
    if bucket == ("scalar",):
        return "scalar" + suffix
    if bucket and bucket[0] == "occ":
        _, level, total = bucket
        return f"occ{level}/{total}slots" + suffix
    if bucket and bucket[0] == "plen":
        _, b = bucket
        if b == 0:
            return "plen0" + suffix
        return f"plen[{2 ** (b - 1)},{2 ** b})tok" + suffix
    if bucket and bucket[0] == "slo":
        _, i, b = bucket
        return f"slo:i{i}b{b}"
    if bucket and bucket[0] == "kvl":
        _, pb, level, total = bucket
        plen = "plen0" if pb == 0 else f"plen[{2 ** (pb - 1)},{2 ** pb})"
        return f"{plen}xocc{level}/{total}slots" + suffix
    if bucket and bucket[0] == "pfc":
        _, pb, level, total = bucket
        plen = "plen0" if pb == 0 else f"plen[{2 ** (pb - 1)},{2 ** pb})"
        return f"chunk:{plen}xocc{level}/{total}slots" + suffix
    if bucket and bucket[0] == "hzn":
        _, qb, level, total = bucket
        q = "q0" if qb == 0 else f"q[{2 ** (qb - 1)},{2 ** qb})"
        return f"horizon:{q}xocc{level}/{total}slots" + suffix
    if bucket and bucket[0] == "spec":
        _, qb, level, total, acc = bucket
        q = "q0" if qb == 0 else f"q[{2 ** (qb - 1)},{2 ** qb})"
        return f"spec:{q}xocc{level}/{total}slotsxacc{acc}" + suffix
    b, ranks = bucket
    lo, hi = 2 ** b, 2 ** (b + 1)
    return f"[{lo},{hi})elems/rank{','.join(map(str, ranks))}" + suffix


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


def kv_layout_bucket(matched: int, active: int, total: int, *,
                     levels: int = 4) -> Tuple:
    """Dispatch key for the serve engine's ``kv_layout`` axis: matched
    prefix-length bucket × occupancy level (aliasing a long match saves a
    long copy; the indirection's cost moves with how busy the slots are)."""
    p = prefix_len_bucket(matched)
    o = occupancy_bucket(active, total, levels=levels)
    return ("kvl", p[1], o[1], total)


def kv_layout_buckets(max_len: int, total: int, *, levels: int = 4) -> List[Tuple]:
    """Every distinct :func:`kv_layout_bucket` of a warm admission (matched
    1..max_len-1 tokens, 0..total active slots), in first-seen order: the
    keys to force when pinning the ``kv_layout`` axis for all of them."""
    return list(dict.fromkeys(
        kv_layout_bucket(m, occ, total, levels=levels)
        for m in range(1, max_len) for occ in range(total + 1)))


def prefill_chunk_bucket(prompt_len: int, active: int, total: int, *,
                         levels: int = 4) -> Tuple:
    """Dispatch key for the serve engine's ``prefill_kernel`` axis:
    prompt-length bucket × occupancy level (the kernel crossover depends
    on how long the prompt is and how busy the pool already is)."""
    p = prefix_len_bucket(prompt_len)
    o = occupancy_bucket(active, total, levels=levels)
    return ("pfc", p[1], o[1], total)


def queue_depth_bucket(depth: int) -> int:
    """Log2 level of the admission-queue depth (0 = empty queue)."""
    if depth <= 0:
        return 0
    return int(math.floor(math.log2(depth))) + 1


def decode_horizon_bucket(queue_depth: int, active: int, total: int, *,
                          levels: int = 4) -> Tuple:
    """Dispatch key for the serve engine's ``decode_horizon`` axis:
    queue-depth level x occupancy level (a long fused horizon amortizes
    per-token host work over more live slots, and delays the queued
    requests, which cannot enter a slot mid-horizon)."""
    q = queue_depth_bucket(queue_depth)
    o = occupancy_bucket(active, total, levels=levels)
    return ("hzn", q, o[1], total)


def accept_rate_level(accept_rate: Optional[float]) -> int:
    """A measured draft-acceptance rate quantized to three levels: below
    0.3 the drafts mostly miss (a verify pass buys barely more than one
    token), from 0.7 they mostly land, and the band between is for the
    measured wall to decide.  ``None`` (no measurement yet) is the middle
    level, so the first trials are not keyed off an invented extreme."""
    if accept_rate is None:
        return 1
    if accept_rate < 0.3:
        return 0
    if accept_rate < 0.7:
        return 1
    return 2


def spec_accept_bucket(queue_depth: int, active: int, total: int,
                       accept_rate: Optional[float] = None, *,
                       levels: int = 4) -> Tuple:
    """Dispatch key for the serve engine's ``spec_draft`` axis: the
    ``decode_horizon`` key's queue-depth level x occupancy level, and the
    engine's recent acceptance level (:func:`accept_rate_level`) — whether a
    verify span beats the plain path depends on the load and on how often
    the drafts land, a property of the traffic only a measurement shows."""
    q = queue_depth_bucket(queue_depth)
    o = occupancy_bucket(active, total, levels=levels)
    return ("spec", q, o[1], total, accept_rate_level(accept_rate))


def slo_pressure_bucket(queued_interactive: int, queued_batch: int) -> Tuple:
    """Dispatch-key extension for SLO-aware horizon and chunk selection:
    the queue's composition, coarsely — interactive waiters at three levels
    (0 / 1 / 2+) x batch waiters at three levels (0 / <= 4 / more).  A long
    device call (a fused horizon, a large prefill chunk) makes every queued
    request wait it out, and what that wait costs depends on who waits; the
    engine appends this key to the ``decode_horizon``, ``prefill_chunk``
    and ``prefill_kernel`` buckets when ``slo_weight`` > 0."""
    i = min(max(queued_interactive, 0), 2)
    b = 0 if queued_batch <= 0 else (1 if queued_batch <= 4 else 2)
    return ("slo", i, b)


def shard_bucket(dp: int, mp: int) -> Tuple:
    """Dispatch-key extension for mesh serving.

    The best decode variant, fused horizon, prefill chunk and verify span
    shift with the mesh shape, so the engine appends this segment LAST to
    those keys on a non-trivial mesh and the controller learns each policy
    per mesh configuration.  Every replica of a group carries the group's
    full ``(dp, mp)``, so a shared VPE learns one policy from all of them.
    ``(1, 1)`` appends nothing: single-device keys stay byte-identical."""
    return ("shard", int(dp), int(mp))


def pad_to_bucket(n: int, *, minimum: int = 16) -> int:
    """Next power of two >= n (floored at ``minimum``): prompt chunks are
    padded to these sizes, so the kernels see few distinct shapes."""
    if n <= minimum:
        return minimum
    return 1 << math.ceil(math.log2(n))
