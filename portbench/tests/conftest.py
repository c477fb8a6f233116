"""Puts the checkout's root and ``src`` on the path, and gives the CPU tests
small cells: the two configurations cut to a smoke size, with short
traffic, run by the same drivers."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = dict(num_hidden_layers=2, hidden_size=128, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, intermediate_size=256, vocab_size=512,
             torch_dtype="float32")


def small_spec(cell: str, **traffic_over):
    """The cell's files, cut to run on the CPU in seconds."""
    from portbench import harness
    bench = harness.load_benchmark()
    spec = harness.cell_spec(bench, cell)
    spec.config = {**spec.config, **SMALL}
    t = dict(spec.traffic)
    if t["driver"] == "serve":
        t.update(clients=3, slots=3, max_len=256, prefill_chunk=32, deck=8,
                 prompt={"dist": "loguniform", "min": 8, "max": 40},
                 output={"dist": "uniform", "min": 4, "max": 12}, trace_seconds=0.5,
                 page_budget=None)
        if t.get("prefix_blocks"):
            t["prefix_blocks"] = 64
        if t.get("shared_prefix"):
            t["shared_prefix"] = {"count": 2, "tokens": 48}
        spec.cell = {**spec.cell, "check": {"requests": 2}}
    else:
        t.update(seq_len=32, batch=2, trace_steps=1)
    t.update(traffic_over)
    spec.traffic = t
    return spec


@pytest.fixture
def small():
    return small_spec


@pytest.fixture
def cuda_device():
    """Skips where there is no CUDA device; decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    return torch.device("cuda")
