"""The harness on the CPU: traffic from the seed, rates and tails over
every request of the window, the result line, the check that nothing of
JAX is loaded, cells found by name, and BENCHMARK.json's shape."""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import generate, harness, stats

ROOT = Path(harness.ROOT)
SERVE_MIXES = ["chat-decode", "shared-prefix", "long-context"]


def _requests(traffic, seed, n):
    """n requests in the order clients 0, 1, ... ask, each as (prompt,
    output, length of its unique part)."""
    gen = generate.ClosedLoop(traffic, 151936, seed)
    out = []
    for i in range(n):
        c = i % gen.clients
        head = (len(gen.prefixes[0]) if gen.prefixes else 0) + (
            len(gen.documents[c]) if gen.documents else 0)
        p, o = gen.next_request(c)
        out.append((p, o, len(p) - head))
    return out


@pytest.mark.parametrize("mix", SERVE_MIXES)
def test_traffic_repeats_for_a_seed_and_differs_across_seeds(mix):
    t = harness.load_json(ROOT / "portbench" / "traffic" / f"{mix}.json")
    k = int(t["deck"])
    n = 3 * k
    a, b, c = _requests(t, 2**31 + 17, n), _requests(t, 2**31 + 17, n), _requests(t, 5, n)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    # every block of ``deck`` requests after the first is the same set of
    # sizes for every seed, in another order
    for blk in (slice(k, 2 * k), slice(2 * k, 3 * k)):
        assert sorted((x[2], x[1]) for x in a[blk]) == sorted((x[2], x[1]) for x in c[blk])
        assert [x[2] for x in a[blk]] != [x[2] for x in c[blk]]


def test_deck_spans_the_distributions():
    q = generate.quantiles({"dist": "loguniform", "min": 128, "max": 1024}, 64)
    assert q == sorted(q) and 128 <= q[0] < 140 and 950 < q[-1] <= 1024
    u = generate.quantiles({"dist": "uniform", "min": 256, "max": 1024}, 64)
    assert abs(np.mean(u) - 640) < 1


def test_train_batches_repeat_and_shift():
    t = harness.load_json(ROOT / "portbench" / "traffic" / "train-4k.json")
    a = generate.TrainBatches(t, 32000, 9).batch_at(2)
    b = generate.TrainBatches(t, 32000, 9).batch_at(2)
    c = generate.TrainBatches(t, 32000, 10).batch_at(2)
    assert np.array_equal(a["tokens"], b["tokens"]) and not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (1, 4096)
    assert np.array_equal(a["tokens"][0, 1:], a["labels"][0, :-1])


def test_percentile_and_rates_take_every_sample():
    xs = [1.0] * 90 + [10.0] * 10
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile(list(range(101)), 95) == 95
    # not a median of per-chunk tails: chunks of 20 have p95 1 for the first four
    assert stats.percentile(xs, 95) != np.median([np.percentile(xs[i:i + 20], 95)
                                                  for i in range(0, 100, 20)])
    assert stats.rate(300, 2.0) == 150.0


def test_e2e_readers_over_a_window():
    from types import SimpleNamespace
    obs = SimpleNamespace(kind="serve", tokens=1000, window_s=4.0, setup_s=3.0,
                          itl_s=[0.01] * 950 + [0.2] * 50, ttft_s=[0.1, 0.3, 0.2, 0.9])
    got = {n: harness.reader(n).read(obs) for n in
           ("output_tok_s", "itl_p95_ms", "ttft_p95_ms.host", "setup_s", "train_tok_s")}
    assert got["output_tok_s"] == 250.0
    assert got["itl_p95_ms"] == pytest.approx(1e3 * np.percentile(obs.itl_s, 95))
    assert got["ttft_p95_ms.host"] == pytest.approx(1e3 * np.percentile(obs.ttft_s, 95))
    assert got["setup_s"] == 3.0 and got["train_tok_s"] is None


def test_window_counts_every_token_once(small):
    """Each token that appears in the window gives either its request's
    first-token time or one inter-token gap."""
    import torch
    from portbench.drivers import serve
    spec = small("qwen3-8b.chat-decode")
    obs = serve.run(spec, 42, 1.5, False, torch.device("cpu"), time.perf_counter())
    assert obs.tokens > 0 and obs.finished > 0
    assert obs.tokens == len(obs.itl_s) + len(obs.ttft_s)
    assert obs.window_s >= 1.5


def test_result_line_has_the_five_keys(small):
    spec = small("qwen3-8b.chat-decode")
    r = harness.run_cell("qwen3-8b.chat-decode", 7, 2.0, False, t0=time.perf_counter(),
                         device="cpu", spec=spec)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"output_tok_s", "itl_p95_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert r["correct"] is True and r["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    json.dumps(r)


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch", "repro_torch.models", "reprox", "jaxtyping", "numpy",
             "repro", "repro.models.layers", "jax", "jaxlib.xla", "flax.linen"]
    assert harness.forbidden_modules(names) == sorted(
        ["repro", "repro.models.layers", "jax", "jaxlib.xla", "flax.linen"])


def test_run_loads_nothing_of_jax(small):
    code = ("import sys, time; sys.path[:0] = [%r, %r, %r]\n"
            "from conftest import small_spec\nfrom portbench import harness\n"
            "harness.run_cell('qwen3-8b.chat-decode', 3, 0.5, True, t0=time.perf_counter(),"
            " device='cpu', spec=small_spec('qwen3-8b.chat-decode'))\n"
            "print(harness.forbidden_modules())\n") % (
        str(ROOT / "portbench" / "tests"), str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                          "--workload", "qwen3-8b.chat-decode", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT),
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_new_cell_is_found_by_its_files(tmp_path):
    bench = {"configs": [{"name": "m", "file": "portbench/configs/m.json"}],
             "workloads": [{"name": "m.mix", "config": "m", "traffic": "mix", "chips": 1}],
             "end_to_end": [{"name": "setup_s"},
                            {"name": "output_tok_s", "workloads": ["m.mix"]},
                            {"name": "other", "workloads": ["x.y"]}],
             "per_layer": [{"name": "a", "moves": "output_tok_s"},
                           {"name": "b", "moves": "other"},
                           {"name": "c", "moves": "other", "workloads": ["m.mix"]}]}
    for sub, name, body in (("configs", "m", {"n": 1}), ("traffic", "mix", {"driver": "serve"}),
                            ("cells", "m.mix", {"limits": {}})):
        d = tmp_path / "portbench" / sub
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.json").write_text(json.dumps(body))
    spec = harness.cell_spec(bench, "m.mix", root=tmp_path)
    assert spec.config == {"n": 1} and spec.traffic["driver"] == "serve"
    assert [m["name"] for m in harness.metrics_for(bench, "m.mix", False)] == \
        ["setup_s", "output_tok_s"]
    assert [m["name"] for m in harness.metrics_for(bench, "m.mix", True)] == ["a", "c"]
    with pytest.raises(KeyError):
        harness.cell_spec(bench, "m.other", root=tmp_path)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(text):
    """A why, a layer, a source or a word of the command: 1 to 200
    characters on one line, with no tab."""
    return isinstance(text, str) and 1 <= len(text) <= 200 and not set(text) & set("\t\r\n")


def test_benchmark_json_keeps_the_contract_shape():
    b = harness.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert not any(w.startswith("/") or ".." in w.split("/") for w in b["command"])
    assert b["paths"] == ["portbench"] and all(PATH.match(p) for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    configs = {c["name"] for c in b["configs"]}
    assert 1 <= len(b["workloads"]) <= 24
    cells = {w["name"] for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    assert configs == {w["config"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(b["per_layer"]) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert _line(w["why"]) and NAME.match(w["name"]) and NAME.match(w["traffic"])
        spec = harness.cell_spec(b, w["name"])
        assert spec.traffic["driver"] in ("serve", "train")
        got = [m["name"] for m in harness.metrics_for(b, w["name"], False)]
        assert "setup_s" in got and len(got) >= 2
        assert harness.metrics_for(b, w["name"], True)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", [])) <= cells
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert all(w in e2e[m["moves"]].get("workloads", cells) for w in m.get("workloads", []))
    assert len(json.dumps(b)) < 64 * 1024
