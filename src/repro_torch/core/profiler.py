"""Online profiler — the perf_event analogue.

The paper samples hardware counters (CPU cycles) through Linux
perf_event, at up to 20% overhead, and uses "cycles spent per function"
as the sole hot-ness metric.  Our equivalent for PyTorch code:

* wall-clock seconds per op call (fenced by a device synchronisation),
  split into *warm-up* (first call per variant, the paper's "initial
  warm-up phase") and *steady-state* samples;
* optional counters (FLOPs / bytes computed from shapes), the static
  analogue of hardware counters, attached per variant;
* Welford mean/variance so the controller can require wins larger than
  measurement noise (the paper notes the DSP-side std-dev is inflated by
  the profiler itself — we make the same effect measurable).

Stats are kept per (op, variant, shape_bucket) in plain python — the
profiler must never get traced into the computation.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class Welford:
    """Streaming mean/variance."""

    n: int = 0
    mean: float = 0.0
    m2: float = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    @property
    def var(self) -> float:
        return self.m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(self.var)

    def as_dict(self) -> Dict[str, float]:
        return {"n": self.n, "mean": self.mean, "m2": self.m2}

    @classmethod
    def from_dict(cls, d: Dict[str, float]) -> "Welford":
        return cls(n=int(d["n"]), mean=float(d["mean"]), m2=float(d["m2"]))


@dataclasses.dataclass
class SampleSet:
    """Per (op, variant, bucket) statistics, warm-up split out."""

    warmup: Welford = dataclasses.field(default_factory=Welford)
    steady: Welford = dataclasses.field(default_factory=Welford)
    # static counters from the compiled artifact, if attached
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)

    def record(self, seconds: float, *, warm: bool) -> None:
        (self.warmup if warm else self.steady).add(seconds)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "warmup": self.warmup.as_dict(),
            "steady": self.steady.as_dict(),
            "counters": dict(self.counters),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SampleSet":
        s = cls(
            warmup=Welford.from_dict(d["warmup"]),
            steady=Welford.from_dict(d["steady"]),
        )
        s.counters = dict(d.get("counters", {}))
        return s


Key = Tuple[str, str, Tuple]  # (op, variant, bucket)


class Profiler:
    """Collects timing samples; pure python, zero trace footprint."""

    def __init__(self, clock=time.perf_counter) -> None:
        self._clock = clock
        self._stats: Dict[Key, SampleSet] = {}
        # total steady seconds per op — the paper's hot-ness ranking
        self._op_seconds: Dict[str, float] = {}
        self.enabled = True

    # -- recording ----------------------------------------------------
    def samples(self, op: str, variant: str, bucket: Tuple) -> SampleSet:
        key = (op, variant, bucket)
        if key not in self._stats:
            self._stats[key] = SampleSet()
        return self._stats[key]

    def record(self, op: str, variant: str, bucket: Tuple, seconds: float) -> None:
        if not self.enabled:
            return
        ss = self.samples(op, variant, bucket)
        warm = ss.warmup.n == 0 and ss.steady.n == 0
        ss.record(seconds, warm=warm)
        if not warm:
            self._op_seconds[op] = self._op_seconds.get(op, 0.0) + seconds

    def attach_counters(self, op: str, variant: str, bucket: Tuple, counters: Dict[str, float]) -> None:
        self.samples(op, variant, bucket).counters.update(counters)

    def time(self):
        return self._clock()

    # -- queries ------------------------------------------------------
    def hot_ops(self, user_ops) -> list:
        """Ops ranked by total steady-state seconds (descending)."""
        ranked = sorted(
            ((self._op_seconds.get(op, 0.0), op) for op in user_ops),
            reverse=True,
        )
        return [op for sec, op in ranked if sec > 0.0]

    def mean(self, op: str, variant: str, bucket: Tuple) -> Optional[float]:
        key = (op, variant, bucket)
        ss = self._stats.get(key)
        if ss is None or ss.steady.n == 0:
            return None
        return ss.steady.mean

    def count(self, op: str, variant: str, bucket: Tuple) -> int:
        ss = self._stats.get((op, variant, bucket))
        return 0 if ss is None else ss.steady.n + ss.warmup.n

    def buckets_seen(self, op: str) -> list:
        return sorted({k[2] for k in self._stats if k[0] == op}, key=repr)

    def variants_measured(self, op: str, bucket: Tuple) -> list:
        return sorted({k[1] for k in self._stats if k[0] == op and k[2] == bucket and self._stats[k].steady.n > 0})

    # -- (de)serialization for checkpointing --------------------------
    def as_dict(self) -> Dict[str, Any]:
        return {
            "stats": [
                {"op": op, "variant": v, "bucket": repr(b), "data": ss.as_dict()}
                for (op, v, b), ss in self._stats.items()
            ],
            "op_seconds": dict(self._op_seconds),
        }

    def load_dict(self, d: Dict[str, Any]) -> None:
        # buckets round-trip through repr/eval of plain tuples of ints/strs
        self._stats.clear()
        for item in d["stats"]:
            bucket = eval(item["bucket"], {"__builtins__": {}})  # noqa: S307 - trusted checkpoint
            self._stats[(item["op"], item["variant"], bucket)] = SampleSet.from_dict(item["data"])
        self._op_seconds = dict(d["op_seconds"])
