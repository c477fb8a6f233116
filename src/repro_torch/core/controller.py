"""Decision engine — hot detection, blind offload, keep-or-revert.

Paper semantics implemented here:

* **Hot detection** (§3.1): ops ranked by accumulated execution seconds
  (our CPU-cycles analogue); system-tagged ops excluded.
* **Blind offload** (§3.1): when an op is hot and has an untried variant
  for the current shape bucket, trial it for ``trial_samples`` calls and
  compare against the incumbent.  "we off-load the candidate function
  and we observe if this results in a performance improvement,
  eventually reverting our choice."
* **Revert** (§5.2, the FFT row): if the trial is *slower* (e.g. FFT on
  the DSP: 0.7x) the incumbent is restored.  Additionally, a selected
  variant that regresses versus its own history (input-pattern change)
  triggers re-exploration.
* **Hysteresis / noise-awareness** (beyond paper, motivated by the
  paper's observation that profiling inflates variance): a switch
  requires  mean_new < mean_old * (1 - hysteresis)  AND the gap must
  exceed ``noise_sigmas`` joint standard errors.
* **Cost-guided trial ordering** (beyond paper): if variants carry
  ``cost_hint`` models, untried variants are ordered by predicted win so
  the first blind trial is the most promising one.

Decisions are kept per (op, shape_bucket) — the paper's decision-tree-
on-size suggestion (§5.2 / Fig. 2b) falls out of this keying.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from .profiler import Profiler
from .registry import Registry


@dataclasses.dataclass
class Decision:
    """Dispatch state for one (op, bucket)."""

    selected: str
    trialing: Optional[str] = None
    trial_remaining: int = 0
    tried: List[str] = dataclasses.field(default_factory=list)
    calls_since_explore: int = 0
    # audit log of (event, variant, detail) — EXPERIMENTS.md evidence
    history: List[Tuple[str, str, str]] = dataclasses.field(default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Decision":
        d = dict(d)
        d["history"] = [tuple(h) for h in d.get("history", [])]
        return cls(**d)


class Controller:
    def __init__(
        self,
        registry: Registry,
        profiler: Profiler,
        *,
        min_samples: int = 3,
        trial_samples: int = 3,
        hysteresis: float = 0.05,
        noise_sigmas: float = 1.0,
        reexplore_period: int = 0,  # 0 = never re-explore spontaneously
        hot_fraction: float = 0.0,  # 0 = every measured op is eligible
    ) -> None:
        self.registry = registry
        self.profiler = profiler
        self.min_samples = min_samples
        self.trial_samples = trial_samples
        self.hysteresis = hysteresis
        self.noise_sigmas = noise_sigmas
        self.reexplore_period = reexplore_period
        self.hot_fraction = hot_fraction
        self._decisions: Dict[Tuple[str, Tuple], Decision] = {}
        # bumped on every switch/revert; jitted-step users re-build on change
        self.version = 0

    # -- state access ---------------------------------------------------
    def decision(self, op: str, bucket: Tuple) -> Decision:
        key = (op, bucket)
        if key not in self._decisions:
            entry = self.registry.op(op)
            d = Decision(selected=entry.default)
            d.tried.append(entry.default)
            self._decisions[key] = d
        return self._decisions[key]

    def selected(self, op: str, bucket: Tuple) -> str:
        return self.decision(op, bucket).selected

    # -- the per-call selection hook (called by the dispatcher) ---------
    def select(self, op: str, bucket: Tuple) -> str:
        d = self.decision(op, bucket)
        if d.trialing is not None:
            return d.trialing
        return d.selected

    # -- periodic action (the paper's "VPE acts to alter the behaviour") -
    def on_sample(self, op: str, bucket: Tuple, variant: str) -> None:
        """Called by the dispatcher after every recorded sample."""
        entry = self.registry.op(op)
        if entry.system:
            return
        d = self.decision(op, bucket)

        if d.trialing is not None and variant == d.trialing:
            d.trial_remaining -= 1
            if d.trial_remaining <= 0:
                self._conclude_trial(op, bucket, d)
            return

        d.calls_since_explore += 1
        if self._should_start_trial(op, bucket, d):
            self._start_trial(op, bucket, d)

    # -- internals -------------------------------------------------------
    def _is_hot(self, op: str) -> bool:
        hot = self.profiler.hot_ops(self.registry.user_ops())
        if not hot:
            return False
        if self.hot_fraction <= 0.0:
            return op in hot
        k = max(1, int(math.ceil(len(hot) * self.hot_fraction)))
        return op in hot[:k]

    def _untried(self, op: str, bucket: Tuple, d: Decision) -> List[str]:
        names = [v for v in self.registry.op(op).variant_names() if v not in d.tried]
        if not names:
            return []
        # beyond-paper: order by predicted cost if hints exist
        def pred(vname: str) -> float:
            v = self.registry.variant(op, vname)
            if v.cost_hint is None:
                return math.inf
            try:
                h = v.cost_hint()
                return float(h.get("seconds", h.get("flops", math.inf)))
            except Exception:
                return math.inf
        names.sort(key=pred)
        return names

    def _should_start_trial(self, op: str, bucket: Tuple, d: Decision) -> bool:
        if not self._is_hot(op):
            return False
        if self.profiler.samples(op, d.selected, bucket).steady.n < self.min_samples:
            return False
        if self._untried(op, bucket, d):
            return True
        if self.reexplore_period and d.calls_since_explore >= self.reexplore_period:
            return True
        return False

    def _start_trial(self, op: str, bucket: Tuple, d: Decision) -> None:
        untried = self._untried(op, bucket, d)
        if untried:
            cand = untried[0]
        else:
            # re-exploration: re-measure the best rejected alternative
            others = [v for v in self.registry.op(op).variant_names() if v != d.selected]
            if not others:
                return
            means = [(self.profiler.mean(op, v, bucket) or math.inf, v) for v in others]
            cand = min(means)[1]
        d.trialing = cand
        d.trial_remaining = self.trial_samples
        d.calls_since_explore = 0
        if cand not in d.tried:
            d.tried.append(cand)
        d.history.append(("trial", cand, "blind offload"))

    def _conclude_trial(self, op: str, bucket: Tuple, d: Decision) -> None:
        cand, d.trialing = d.trialing, None
        inc = d.selected
        m_new = self.profiler.mean(op, cand, bucket)
        m_old = self.profiler.mean(op, inc, bucket)
        if m_new is None or m_old is None:
            d.history.append(("revert", cand, "no steady samples"))
            return
        s_new = self.profiler.samples(op, cand, bucket).steady
        s_old = self.profiler.samples(op, inc, bucket).steady
        sem = math.sqrt(
            (s_new.var / max(s_new.n, 1)) + (s_old.var / max(s_old.n, 1))
        )
        win = m_old - m_new
        if m_new < m_old * (1.0 - self.hysteresis) and win > self.noise_sigmas * sem:
            d.selected = cand
            self.version += 1
            d.history.append(
                ("switch", cand, f"{m_old * 1e3:.3f}ms -> {m_new * 1e3:.3f}ms ({m_old / m_new:.2f}x)")
            )
        else:
            self.version += 0  # explicit: no version bump on revert-to-incumbent
            d.history.append(
                ("revert", cand, f"candidate {m_new * 1e3:.3f}ms vs incumbent {m_old * 1e3:.3f}ms")
            )

    # -- static (trace-time) dispatch for jitted steps --------------------
    def select_static(self, op: str, bucket: Tuple) -> str:
        """Variant to bake into a jitted computation.

        Unlike :meth:`select` this never returns an in-flight trial —
        jitted steps switch only at re-trace boundaries, driven by
        ``version`` changes (the runtime re-builds the step when the
        controller version moves, the analogue of swapping the
        function pointer and letting MCJIT re-finalize the module).
        """
        return self.decision(op, bucket).selected

    # -- forced actions (runtime/fault hooks) ----------------------------
    def force(self, op: str, bucket: Tuple, variant: str, reason: str = "forced") -> None:
        d = self.decision(op, bucket)
        if variant not in self.registry.op(op).variants:
            raise KeyError(f"unknown variant {variant!r} for op {op!r}")
        if d.selected != variant:
            d.selected = variant
            self.version += 1
        if variant not in d.tried:
            d.tried.append(variant)
        d.history.append(("force", variant, reason))

    # -- (de)serialization -------------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "decisions": [
                {"op": op, "bucket": repr(b), "data": d.as_dict()}
                for (op, b), d in self._decisions.items()
            ],
        }

    def load_dict(self, d: Dict[str, Any]) -> None:
        self.version = int(d["version"])
        self._decisions.clear()
        for item in d["decisions"]:
            bucket = eval(item["bucket"], {"__builtins__": {}})  # noqa: S307 - trusted checkpoint
            self._decisions[(item["op"], bucket)] = Decision.from_dict(item["data"])
