"""Device idle time inside the program's own host ranges.

While a profiler records, the port enters named ranges around the serving
engine's phases (``repro_torch.core.spans``: ``serve.admit``,
``serve.prefill_chunk``, ``serve.decode``).  Each is a host event of the
traced stretch (:class:`portbench.trace.Trace`), on the clock of the device
operations, so the idle time inside a range is its host intervals less the
device operations that ran within them.  A program without the ranges (an
older commit) leaves the readers nothing to read.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from portbench.trace import Trace, _union


def overlap_us(xs: Sequence[Tuple[float, float]],
               ys: Sequence[Tuple[float, float]]) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(trace: Trace, name: str) -> Optional[float]:
    """Percent of the traced stretch's ``window_s`` that lies inside the
    range ``name`` with no device operation running; None when the stretch
    holds no such range."""
    inside = _union([(a, b) for n, a, b in trace.host if n == name])
    if not inside or trace.window_s <= 0:
        return None
    busy = _union([(a, b) for _, a, b in trace.ops])
    idle_us = sum(b - a for a, b in inside) - overlap_us(inside, busy)
    return 100.0 * idle_us / 1e6 / trace.window_s
