"""The caller indirection (paper Fig. 1).

Every VPE op call goes through a wrapper.  In the paper the wrapper is a
generated stub holding a function pointer that MCJIT patches to point
either at the local code or at the remote-target handler.  Here the
wrapper is :class:`VPEFunction`: it consults the controller for the
currently selected variant (the "function pointer"), times the call, and
feeds the sample back.

CUDA runs asynchronously: a call returns once its kernels are queued.
:meth:`VPE.call` therefore synchronises every CUDA device the result
lives on before it stops the clock — without that fence the profiler
would time kernel launches, not the work, and the controller would pick
variants on launch cost.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .controller import Controller
from .profiler import Profiler
from .registry import Registry
from .shape_class import shape_bucket


def block_until_ready(out: Any) -> Any:
    """Synchronise every CUDA device that holds a tensor of ``out``."""
    devices = {leaf.device for leaf in pytree.tree_leaves(out)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


class VPEFunction:
    """Callable wrapper bound to one op — the paper's "caller"."""

    def __init__(self, vpe: "VPE", op: str) -> None:
        self.vpe = vpe
        self.op = op
        entry = vpe.registry.op(op)
        functools.update_wrapper(self, entry.variants[entry.default].fn,
                                 updated=())

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.vpe.call(self.op, *args, **kwargs)

    def variant_for(self, *args: Any) -> str:  # introspection helper
        return self.vpe.controller.select(self.op, shape_bucket(*args))


class VPE:
    """Facade tying registry + profiler + controller together."""

    def __init__(
        self,
        registry: Optional[Registry] = None,
        *,
        controller_kwargs: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.registry = registry if registry is not None else Registry()
        self.profiler = Profiler()
        self.controller = Controller(self.registry, self.profiler,
                                     **(controller_kwargs or {}))

    # -- registration sugar ---------------------------------------------
    def op(self, name: str, *, variant: str = "reference", system: bool = False, **vkw):
        """Decorator: register ``fn`` as the default variant of ``name``."""

        def deco(fn: Callable) -> VPEFunction:
            self.registry.register_op(name, system=system)
            self.registry.register_variant(name, variant, fn, default=True, **vkw)
            return VPEFunction(self, name)

        return deco

    def variant(self, name: str, *, variant: str, **vkw):
        """Decorator: register an additional variant of an existing op."""

        def deco(fn: Callable) -> Callable:
            self.registry.register_variant(name, variant, fn, **vkw)
            return fn

        return deco

    def wrap(self, name: str) -> VPEFunction:
        return VPEFunction(self, name)

    # -- eager dispatch ----------------------------------------------------
    def call(self, op: str, *args: Any, **kwargs: Any) -> Any:
        bucket = shape_bucket(*args)
        vname = self.controller.select(op, bucket)
        fn = self.registry.variant(op, vname).fn
        t0 = self.profiler.time()
        out = block_until_ready(fn(*args, **kwargs))
        dt = self.profiler.time() - t0
        self.profiler.record(op, vname, bucket, dt)
        self.controller.on_sample(op, bucket, vname)
        return out

    # -- static dispatch (selection outside the timed call) -------------------
    def static_variant(self, op: str, bucket: Tuple = ("static",)) -> Callable:
        vname = self.controller.select_static(op, bucket)
        return self.registry.variant(op, vname).fn

    def static_variant_name(self, op: str, bucket: Tuple = ("static",)) -> str:
        return self.controller.select_static(op, bucket)

    # -- reporting -----------------------------------------------------------
    def report(self) -> str:
        lines = ["op/bucket decision table:"]
        for (op, bucket), d in sorted(self.controller._decisions.items(), key=repr):
            lines.append(f"  {op} {bucket}: selected={d.selected} tried={d.tried}")
            for ev, v, detail in d.history:
                lines.append(f"    - {ev} {v}: {detail}")
        return "\n".join(lines)

    # -- checkpointable state --------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"profiler": self.profiler.as_dict(),
                "controller": self.controller.as_dict()}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.profiler.load_dict(d["profiler"])
        self.controller.load_dict(d["controller"])
