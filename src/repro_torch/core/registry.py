"""Op/variant registry — the set of dispatch "targets" VPE can choose from.

The paper's system discovers, at run time, that a *function* has an
alternative execution target (the DSP) and rewires a function pointer to
reach it.  In this adaptation an *op* is a named computation with one
or more registered *variants* (implementations).  A variant is any
callable with the op's signature: a pure-jnp reference, a Pallas kernel
wrapper, a differently-sharded implementation, etc.

The registry is deliberately dumb: it stores variants and metadata.  All
policy (which variant to run) lives in the controller; all mechanism
(how calls reach the selected variant) lives in the dispatcher.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class Variant:
    """One executable implementation of an op.

    cost_hint:  optional napkin-math cost model ``f(*abstract_args) ->
                dict(flops=..., bytes=...)`` used by the cost-guided
                controller (beyond-paper extension) to order trials.
    setup_cost_s: one-time cost of switching to this variant (compile
                time / weight reshard).  The paper's DSP had ~100 ms of
                transfer setup; for us it is the kernel build and load on first
                call, which the profiler measures as warm-up.
    tags:       free-form strings ("pallas", "reference", "sharding:tp")
    """

    name: str
    fn: Callable[..., Any]
    cost_hint: Optional[Callable[..., Dict[str, float]]] = None
    setup_cost_s: float = 0.0
    tags: tuple = ()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Variant({self.name!r}, tags={self.tags})"


@dataclasses.dataclass
class OpEntry:
    name: str
    variants: Dict[str, Variant] = dataclasses.field(default_factory=dict)
    default: Optional[str] = None
    # ops tagged `system` are excluded from optimization, mirroring the
    # paper's exclusion of system calls from the analysis.
    system: bool = False

    def variant_names(self) -> List[str]:
        return list(self.variants)


class Registry:
    """Mutable mapping op-name -> OpEntry."""

    def __init__(self) -> None:
        self._ops: Dict[str, OpEntry] = {}

    # -- registration -------------------------------------------------
    def register_op(self, name: str, *, system: bool = False) -> OpEntry:
        if name in self._ops:
            raise ValueError(f"op {name!r} already registered")
        entry = OpEntry(name=name, system=system)
        self._ops[name] = entry
        return entry

    def register_variant(
        self,
        op: str,
        variant: str,
        fn: Callable[..., Any],
        *,
        cost_hint: Optional[Callable[..., Dict[str, float]]] = None,
        setup_cost_s: float = 0.0,
        tags: tuple = (),
        default: bool = False,
    ) -> Variant:
        if op not in self._ops:
            self.register_op(op)
        entry = self._ops[op]
        if variant in entry.variants:
            raise ValueError(f"variant {variant!r} already registered for op {op!r}")
        v = Variant(variant, fn, cost_hint=cost_hint, setup_cost_s=setup_cost_s, tags=tuple(tags))
        entry.variants[variant] = v
        if default or entry.default is None:
            entry.default = variant
        return v

    # -- queries ------------------------------------------------------
    def op(self, name: str) -> OpEntry:
        return self._ops[name]

    def has_op(self, name: str) -> bool:
        return name in self._ops

    def ops(self) -> List[str]:
        return list(self._ops)

    def user_ops(self) -> List[str]:
        """Ops eligible for optimization (paper: syscalls excluded)."""
        return [n for n, e in self._ops.items() if not e.system]

    def variant(self, op: str, variant: str) -> Variant:
        return self._ops[op].variants[variant]


# A process-global default registry, analogous to the single JIT session
# in the paper's prototype.  Library code may also instantiate private
# registries (tests do).
GLOBAL = Registry()


def reset_global() -> None:
    """Testing hook — drop all globally registered ops."""
    GLOBAL._ops.clear()
