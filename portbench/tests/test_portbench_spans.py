"""The readers of the program's serving ranges on the CPU: the device idle
inside ``serve.admit``, ``serve.prefill_chunk`` and ``serve.decode`` on a
hand-made trace, their sum against ``idle_share.serve``, the idle gaps put
down to them, nothing read where a range is absent or the run untraced,
``prefill_wait_p95_ms`` over the window's part of
``ServeStats.prefill_wait_s``, and a traced small cell that prints all
four."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, spans
from portbench.trace import Trace

SHARES = {"idle_share.admit": "serve.admit", "idle_share.prefill": "serve.prefill_chunk",
          "idle_share.decode": "serve.decode"}
NEW = list(SHARES) + ["prefill_wait_p95_ms"]


def _trace(host, ops, window_us=200.0):
    return Trace(window_s=window_us / 1e6, ops=[("k", a, b) for a, b in ops], ranges={},
                 host=[(n, a, b) for n, a, b in host])


# device busy [0, 10], [20, 30], [50, 100] and [140, 150] (two overlapping
# launches count once); idle 10 + 20 + 40 + 50 = 120 of 200 us
OPS = [(0, 10), (20, 30), (50, 80), (70, 100), (140, 150)]
HOST = [("portbench.engine_step", 0, 190),
        ("serve.admit", 5, 25),              # idle 10..20: 10
        ("serve.prefill_chunk", 30, 60),     # idle 30..50: 20
        ("serve.decode", 60, 130),           # idle 100..130: 30
        ("serve.decode.commit", 100, 130),
        ("serve.prefill_chunk", 160, 170),   # idle 10
        ("serve.decode", 170, 175),          # idle 5
        ("serve.decode", 172, 174)]          # nested in the one before: once
WANT = {"idle_share.admit": 5.0, "idle_share.prefill": 15.0, "idle_share.decode": 17.5}


def _obs(trace, kind="serve"):
    return SimpleNamespace(kind=kind, trace=trace)


def test_idle_inside_each_range_on_a_known_trace():
    obs = _obs(_trace(HOST, OPS))
    got = {n: harness.reader(n).read(obs) for n in SHARES}
    assert got == pytest.approx(WANT)
    serve = harness.reader("idle_share.serve").read(obs)
    assert serve == pytest.approx(60.0)
    assert sum(got.values()) <= serve
    # the breakdown puts each gap down to the innermost range around it
    assert obs.trace.idle_gaps() == [["serve.decode.commit", pytest.approx(40e-6)],
                                     ["serve.prefill_chunk", pytest.approx(20e-6)],
                                     ["serve.admit", pytest.approx(10e-6)]]


def test_overlap_of_interval_lists():
    assert spans.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_us([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_us([(0, 100)], [(1, 2), (3, 5), (99, 120)]) == 4
    rng = np.random.default_rng(0)
    for _ in range(50):
        xs = spans._union(sorted(tuple(sorted(rng.integers(0, 100, 2))) for _ in range(5)))
        ys = spans._union(sorted(tuple(sorted(rng.integers(0, 100, 2))) for _ in range(5)))
        grid = np.zeros(100, bool), np.zeros(100, bool)
        for g, ivs in zip(grid, (xs, ys)):
            for a, b in ivs:
                g[a:b] = True
        assert spans.overlap_us(xs, ys) == np.sum(grid[0] & grid[1])


@pytest.mark.parametrize("name", list(SHARES))
def test_shares_read_nothing_without_their_range(name):
    r = harness.reader(name)
    assert r.read(_obs(None)) is None                       # untraced
    assert r.read(_obs(_trace(HOST, OPS), kind="train")) is None
    # a program without the ranges (an older commit)
    assert r.read(_obs(_trace([h for h in HOST if not h[0].startswith("serve.")], OPS))) is None


def test_prefill_wait_p95_reads_the_windows_entries():
    from repro_torch.runtime.serve_loop import ServeStats
    before = [5.0] * 10                           # set-up's waits: not the window's
    window = [0.001 * k for k in range(101)]
    obs = SimpleNamespace(kind="serve", stats0=ServeStats(prefill_wait_s=list(before)),
                          stats1=ServeStats(prefill_wait_s=before + window))
    got = harness.reader("prefill_wait_p95_ms").read(obs)
    assert got == pytest.approx(1e3 * np.percentile(window, 95))
    obs.stats1 = ServeStats(prefill_wait_s=list(before))     # no first token in the window
    assert harness.reader("prefill_wait_p95_ms").read(obs) is None
    older = SimpleNamespace(ttft_s=[0.1])                     # a program without the counter
    obs.stats0 = obs.stats1 = older
    assert harness.reader("prefill_wait_p95_ms").read(obs) is None
    obs.kind = "train"
    assert harness.reader("prefill_wait_p95_ms").read(obs) is None


def test_traced_small_cell_prints_the_four(small):
    """The program's ranges reach the readers through the harness's traced
    stretch (on the CPU no device operation runs: idle is the ranges'
    whole length)."""
    cell = "qwen3-8b.chat-decode"
    r = harness.run_cell(cell, 2**31 + 11, 1.0, True, t0=time.perf_counter(), device="cpu",
                         spec=small(cell, trace_seconds=0.3))
    m = {n: v["value"] for n, v in r["metrics"].items()}
    assert set(NEW) <= set(m), sorted(m)
    assert all(m[n] > 0 for n in SHARES)
    assert sum(m[n] for n in SHARES) <= m["idle_share.serve"] + 1e-6
    assert m["prefill_wait_p95_ms"] >= 0
