"""The family seam: ``port.family`` in a configuration file (default
``dense``) names two modules, found by that name.

``families/<family>.py`` is the program-facing side:

* ``dims(conf)``: the sizes the family's reference, weights and work counts
  read, as an object whose ``family`` is the family's name;
* ``port_config(conf, d)``: the port's ``ModelConfig`` with the file's
  ``port`` pins (``repro_torch`` is imported inside the function);
* ``leaf_specs(d)``: ``(path, shape, init, dtype)`` of every leaf, in the
  port's parameter layout (:mod:`portbench.weights` makes them);
* ``layer_matmul_params(d)``, ``token_flops(d, context, logits)``: the
  model FLOPs of the ``*_mfu`` shares (:mod:`portbench.work`).

``reference/<family>.py`` is the plain f32 reference, which imports nothing
of the program: ``serve_logits(d, params, tokens, start, precision)`` and,
where the family trains, ``loss(d, params, tokens, labels, precision,
remat)``.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


def present() -> List[str]:
    """The families that have a file here."""
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def program(family: str) -> ModuleType:
    """``families/<family>.py``."""
    if family not in present():
        raise ValueError(f"no family {family!r} in portbench/families; have {present()}")
    return importlib.import_module(f"portbench.families.{family}")


def reference(family: str) -> ModuleType:
    """``reference/<family>.py``."""
    program(family)
    return importlib.import_module(f"portbench.reference.{family}")


def for_config(conf: Dict) -> ModuleType:
    """The program-facing module of a configuration file's family."""
    return program(conf.get("port", {}).get("family", "dense"))
