"""Deterministic fault injection for the serving stack.

The port's copy of ``repro.runtime.serve_faults``.  A serve step is a
pipeline of independently fenced spans — chunked prefill, single-step
decode, fused horizons, the speculative verify pass, page allocation,
replica dispatch — and each span has its own blast radius and its own
recovery rung.  So the harness is a *plan*, not a hook: a list of
:class:`FaultSpec` records, each naming an injection **site** (which
span), a **kind** (what goes wrong), and a per-site invocation index
**at** (when).  The engine calls :meth:`FaultPlan.take` at every
hookable span; the plan counts invocations per site and hands back the
matching spec — or ``None``, the common case, which costs one dict
increment.  What a fault of each kind does to the engine lives in the
engine's recovery code, not here.

Three fault kinds cover the failure model (``docs/fault_tolerance.md``):

``device``
    The span's device call raises.  Injected *before* dispatch: a real
    CUDA error after a launch leaves the context unusable, which no rung
    of the ladder can recover from (that is what replica failover is
    for), so the engine lets a real one propagate.
``nan``
    The span completes but its logits were poisoned — the fetched
    tokens for the planned slot (or every slot) are replaced with an
    out-of-vocab sentinel.  Exercises the always-on token validation
    and per-slot quarantine path.
``stall``
    The span's fence hangs long enough to trip the
    :class:`~repro_torch.distributed.straggler.StepWatchdog`.  The value
    still arrives (late), so the engine commits it and demotes the
    variant that stalled.

Determinism: a plan is constructed once (explicitly or via
:meth:`FaultPlan.seeded`) and consumed in engine-step order, so the
same plan against the same workload injects at identical coordinates
every run — which is what lets the chaos tests assert token-exact
parity of survivors against a fault-free run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.fault import SimulatedFault

# Injection sites = the engine's fenced spans.  "decode" is the
# single-step path, "fused" the multi-token horizon, "spec" the
# speculative verify pass; "prefill" is one chunked-prefill call;
# "page_alloc" is PagePool.alloc via the engine's escalation ladder;
# "dispatch" is the replica group handing a request to a replica (the
# group takes it, an engine never does).
SITES: Tuple[str, ...] = (
    "decode", "fused", "spec", "prefill", "page_alloc", "dispatch")

KINDS: Tuple[str, ...] = ("device", "nan", "stall")

# NaN/stall need a fenced span with logits / a watchdog; allocation and
# dispatch can only die.
_DEVICE_ONLY = ("page_alloc", "dispatch")


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault: *kind* goes wrong at the *at*-th invocation of
    *site* (0-based, counted per site).  ``slot`` narrows a ``nan``
    fault to one engine slot (None poisons every active slot).  ``note``
    is free-form provenance for logs and test assertions."""
    site: str
    kind: str
    at: int
    slot: Optional[int] = None
    note: str = ""

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.site in _DEVICE_ONLY and self.kind != "device":
            raise ValueError(
                f"site {self.site!r} only supports kind='device'")
        if self.at < 0:
            raise ValueError("fault index must be >= 0")


class FaultPlan:
    """A consumable schedule of :class:`FaultSpec` records.

    The engine calls :meth:`take` once per hookable span; the plan
    increments that site's invocation counter and returns the spec
    planned for that coordinate (or None).  Each spec fires at most
    once; fired specs are appended to :attr:`injected` so tests can
    assert the storm actually landed where it was planned.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: List[FaultSpec] = list(specs)
        self.calls: Dict[str, int] = {s: 0 for s in SITES}
        self.injected: List[FaultSpec] = []
        self._pending: Dict[Tuple[str, int], FaultSpec] = {}
        for spec in self.specs:
            key = (spec.site, spec.at)
            if key in self._pending:
                raise ValueError(f"duplicate fault at {key}")
            self._pending[key] = spec

    def take(self, site: str) -> Optional[FaultSpec]:
        """Count one invocation of *site*; return the fault planned for
        it, if any.  Unknown sites are a programming error."""
        n = self.calls[site]
        self.calls[site] = n + 1
        spec = self._pending.pop((site, n), None)
        if spec is not None:
            self.injected.append(spec)
        return spec

    def peek(self, site: str) -> Optional[FaultSpec]:
        """The fault the *next* ``take(site)`` would return, without
        consuming anything (used by call sites that must decide before
        committing resources)."""
        return self._pending.get((site, self.calls[site]))

    @property
    def exhausted(self) -> bool:
        """True once every planned fault has fired."""
        return not self._pending

    @property
    def remaining(self) -> int:
        return len(self._pending)

    def __len__(self) -> int:
        return len(self.specs)

    def __repr__(self) -> str:
        return (f"FaultPlan({len(self.specs)} specs, "
                f"{len(self.injected)} injected, "
                f"{len(self._pending)} pending)")

    @classmethod
    def seeded(cls, seed: int, n: int, *,
               sites: Sequence[str] = SITES,
               kinds: Sequence[str] = KINDS,
               span: int = 40,
               slots: Optional[int] = None) -> "FaultPlan":
        """A reproducible storm: *n* faults drawn uniformly over
        ``sites`` × ``kinds`` × invocation index ``[0, span)``, deduped
        by (site, at).  ``slots`` bounds the slot coordinate for ``nan``
        faults (None leaves the slot unplanned → poison all).  Device-
        only sites silently coerce their kind."""
        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []
        used = set()
        attempts = 0
        while len(specs) < n and attempts < 50 * n:
            attempts += 1
            site = str(rng.choice(list(sites)))
            kind = str(rng.choice(list(kinds)))
            if site in _DEVICE_ONLY:
                kind = "device"
            at = int(rng.integers(0, span))
            if (site, at) in used:
                continue
            used.add((site, at))
            slot = None
            if kind == "nan" and slots and rng.random() < 0.5:
                slot = int(rng.integers(0, slots))
            specs.append(FaultSpec(site=site, kind=kind, at=at, slot=slot,
                                   note=f"seeded:{seed}"))
        return cls(specs)


__all__ = ["FaultSpec", "FaultPlan", "SimulatedFault", "SITES", "KINDS"]
