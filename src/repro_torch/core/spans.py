"""Named host ranges for ``torch.profiler`` that cost one flag check when no
profiler runs.

A bare ``record_function`` enters a profiler op even with no session open
(several µs a range on the host), which the serving engine's per-step phases
cannot afford.  :func:`span` asks the profiler's own enabled flag first and
hands back a shared no-op context manager when it is off.  Under a session
the range is a host event in the same Kineto trace as the device's kernels,
on the same clock; with CUDA activity on, the profiler also records the
range's device-side annotation.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler session
    records, else a shared no-op.  Use a fixed ``name`` (no request id), and
    never inside code a CUDA graph captures: a range entered at capture is
    not replayed."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
