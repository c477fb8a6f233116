"""Serializable VPE state — JSON round-trip for checkpointing.

The counterpart of ``repro.core.state``.  The whole decision/measurement
state of a VPE instance is plain python data (dicts/lists/floats), so the
training checkpoint embeds ``vpe.state_dict()`` and a restarted job
resumes with all learned dispatch decisions intact — no re-warm-up after
a node failure.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from .dispatch import VPE


def dumps(vpe: VPE) -> str:
    return json.dumps(vpe.state_dict(), sort_keys=True)


def loads(vpe: VPE, payload: str) -> None:
    vpe.load_state_dict(json.loads(payload))


def save(vpe: VPE, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(vpe))


def load(vpe: VPE, path: str) -> None:
    with open(path) as f:
        loads(vpe, f.read())


def summary(state: Dict[str, Any]) -> str:
    """Human-readable one-liner per decision (for logs)."""
    out = []
    for item in state["controller"]["decisions"]:
        out.append(f"{item['op']} {item['bucket']}: {item['data']['selected']}")
    return "\n".join(out)
