"""The device trace of a traced window, reduced to what the metrics read.

``torch.profiler`` (CPU and CUDA activities) runs over a stretch of the
window; :class:`Trace` keeps the device operations (kernels, copies, sets),
the device-side spans of the program's ``record_function`` ranges, the host
operations, and the stretch's host wall.  Busy time is the union of the
device operations' intervals, so overlapping launches count once.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Sequence, Tuple

NAME_CHARS = 120      # a kernel's or host op's name, cut for the result line


def _union(spans: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


@dataclasses.dataclass
class Trace:
    window_s: float
    ops: List[Tuple[str, float, float]]          # (name, start us, end us)
    ranges: Dict[str, float]                     # range name -> device seconds
    host: List[Tuple[str, float, float]]         # host ops (name, start, end)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) / 1e6

    def _merged(self) -> List[Tuple[float, float]]:
        return _union([(a, b) for _, a, b in self.ops])

    def kernel_seconds(self, keys: Sequence[str]) -> Tuple[int, float]:
        """(count, seconds) of the device operations whose name holds any
        of ``keys`` (lower case); the seconds are the union of their
        intervals, so launches that overlap (programmatic dependents) count
        their common time once."""
        spans = [(a, b) for name, a, b in self.ops
                 if any(k in name.lower() for k in keys)]
        return len(spans), sum(b - a for a, b in _union(spans)) / 1e6

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            name = name[:NAME_CHARS]
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The idle time between device operations, summed by the innermost
        host operation running at each gap's middle; the ``k`` largest."""
        merged = self._merged()
        gaps = [(end, start) for (_, end), (start, _) in zip(merged, merged[1:])
                 if start > end]
        host = sorted(self.host, key=lambda e: e[1])
        by: Dict[str, float] = {}
        live: List[Tuple[float, float, str]] = []     # (-start, end, name)
        j = 0
        for end, start in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (start + end) / 2
            while j < len(host) and host[j][1] <= mid:
                name, a, b = host[j]
                heapq.heappush(live, (-a, b, name))
                j += 1
            while live and live[0][1] < mid:
                heapq.heappop(live)
            label = live[0][2][:NAME_CHARS] if live else "no host op"
            by[label] = by.get(label, 0.0) + (start - end) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


class Tracer:
    """``start()`` ... ``stop()`` around a stretch of the window."""

    def __init__(self, device) -> None:
        self.device = device
        self.prof = None
        self.t0 = 0.0

    def warm(self) -> None:
        """One empty profiling session in set-up: the profiler's own start
        costs stay out of the window."""
        self.start()
        self.stop()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> Trace:
        import torch
        from torch.autograd import DeviceType
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        ops, host, ranges = [], [], {}
        for e in self.prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False):
                    ranges[e.name] = ranges.get(e.name, 0.0) + (b - a) / 1e6
                else:
                    ops.append((e.name, a, b))
            else:
                host.append((e.name, a, b))
        self.prof = None
        return Trace(window_s=wall, ops=ops, ranges=ranges, host=host)

