"""Port serving engine against the ``repro`` engine: equal greedy tokens on
the same weights and traffic (the setup of tests/test_kernels.py's engine
parity test, single-step decode), for both pinned backend pairs; chunked
≡ whole-prompt prefill; clean page accounting; the measured axes; the
launcher; and an import-isolation check in a fresh interpreter."""

import os
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import VPE  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

torch.set_num_threads(1)
ENGINE = dict(slots=2, max_len=48, block_size=8)


@pytest.fixture(scope="module")
def setup():
    cfg = ARCHS["qwen3-8b"].reduced()
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_config("qwen3-8b").reduced(), jp, tp


def _requests(mod, vocab, n=5):
    rng = np.random.default_rng(11)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(5, 14))
                                                   ).astype(np.int32),
                        max_new_tokens=6)
            for i in range(n)]


def _run(eng, mod, vocab):
    for r in _requests(mod, vocab):
        eng.submit(r)
    done = eng.run()
    eng.check_kv()
    return {r.rid: [int(t) for t in r.out] for r in done}


def _port(setup, **kw):
    _, tcfg, _, tp = setup
    eng = tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu",
                                          **{**ENGINE, **kw})
    out = _run(eng, tserve, tcfg.vocab_size)
    assert eng.pages.drained and eng.num_active == 0 and not eng.queue
    return out, eng


@pytest.mark.parametrize("jax_impls,port_impls", [
    (("grouped", "gather"), ("grouped", "gather")),
    (("pallas", "pallas"), ("cuda", "cuda"))])
def test_tokens_equal_reference_engine(setup, jax_impls, port_impls):
    cfg, _, jp, _ = setup
    jeng = jserve.ContinuousBatchingEngine(
        cfg, jp, kv_layout="paged", prefill_chunk=8, decode_horizon=1,
        decode_impl=jax_impls[0], prefill_kernel=jax_impls[1], **ENGINE)
    want = _run(jeng, jserve, cfg.vocab_size)
    got, _ = _port(setup, prefill_chunk=8, decode_impl=port_impls[0],
                   prefill_kernel=port_impls[1])
    assert got == want


@pytest.mark.parametrize("impls", [("grouped", "gather"), ("cuda", "cuda"),
                                   ("flat", "gather")])
def test_chunked_equals_whole_prompt(setup, impls):
    chunked, eng = _port(setup, prefill_chunk=8, decode_impl=impls[0],
                         prefill_kernel=impls[1])
    whole, _ = _port(setup, prefill_chunk="whole", decode_impl=impls[0],
                     prefill_kernel=impls[1])
    assert chunked == whole
    assert eng.stats.prefill_chunks > len(chunked)   # really chunked


def test_request_latency_records(setup):
    _, eng = _port(setup, prefill_chunk=4, chunks_per_step=2)
    assert len(eng.completed) == 5 and eng.stats.decode_steps > 0
    for r in eng.completed:
        assert r.status == "done" and len(r.out) == r.max_new_tokens
        assert 0 <= r.queue_wait_s <= r.ttft_s <= r.done_t - r.submit_t
    assert eng.stats.tokens_out == 30 and eng.stats.prefill_tokens == 5
    assert "prefill chunks" in eng.stats.summary()


def test_measured_axes(setup):
    """auto + VPE: both axes registered with the cuda variants and fed;
    tokens stay those of the pinned engines.  A pinned decode backend
    registers its axis as a system op (recorded, never trialed)."""
    vpe = VPE(controller_kwargs=dict(min_samples=1, trial_samples=1))
    got, eng = _port(setup, prefill_chunk=8, vpe=vpe)
    pinned, _ = _port(setup, prefill_chunk=8, decode_impl="grouped",
                      prefill_kernel="gather")
    assert got == pinned
    assert set(vpe.registry.op("serve_decode_impl").variants) == {
        "grouped", "flat", "cuda"}
    assert set(vpe.registry.op("prefill_kernel").variants) == {"gather", "cuda"}
    tried = {v for (op, _), d in vpe.controller._decisions.items()
             if op == "serve_decode_impl" for v in d.tried}
    assert len(tried) > 1                         # the controller trialed
    assert vpe.profiler.buckets_seen("prefill_kernel")
    vpe2 = VPE()
    _port(setup, decode_impl="cuda", prefill_kernel="cuda", vpe=vpe2)
    assert vpe2.registry.op("serve_decode_impl").system
    assert not vpe2.registry.has_op("prefill_kernel")


def test_intake_failures_do_not_raise(setup):
    _, tcfg, _, tp = setup
    eng = tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu", **ENGINE)
    bad = [tserve.Request(rid=0, prompt=np.ones(40, np.int32), max_new_tokens=20),
           tserve.Request(rid=1, prompt=np.zeros(0, np.int32), max_new_tokens=2),
           tserve.Request(rid=2, prompt=np.ones(3, np.int32), max_new_tokens=2,
                          priority="urgent")]
    for r in bad:
        eng.submit(r)
    assert eng.run() == bad
    assert all(r.status == "failed" and r.error == "intake" for r in bad)
    assert eng.stats.failed_requests == 3 and eng.stats.rejected == 3


@pytest.mark.parametrize("kw,item", [
    (dict(kv_layout="contiguous"), "8(a)"), (dict(prefix_blocks=8), "8(b)"),
    (dict(kv_layout="auto"), "8(c)"), (dict(prefill_chunk="auto"), "8(d)"),
    (dict(decode_horizon=4), "8(e)"), (dict(swap=True), "8(f)"),
    (dict(page_budget=12), "8(f)"), (dict(spec_draft=4), "8(g)"),
    (dict(max_queue_depth=3), "8(h)"), (dict(mesh_shape=(1, 2)), "8(i)")])
def test_unported_features_name_their_roadmap_item(setup, kw, item):
    _, tcfg, _, tp = setup
    with pytest.raises(ValueError, match=rf"ROADMAP queue 1, item {re.escape(item)}"):
        tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu", **{**ENGINE, **kw})


def test_bad_arguments_raise(setup):
    _, tcfg, _, tp = setup
    for kw in (dict(decode_impl="pallas"), dict(prefill_kernel="pallas"),
               dict(max_len=50), dict(prefill_chunk=-1), dict(chunks_per_step=0)):
        with pytest.raises(ValueError):
            tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu",
                                            **{**ENGINE, **kw})


def test_engine_device_defaults_to_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, tp = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.ContinuousBatchingEngine(tcfg, tp, **ENGINE)


def test_launcher(capsys):
    tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--continuous", "--device",
                  "cpu", "--requests", "3", "--new-tokens", "3",
                  "--max-len", "48", "--prefill-chunk", "8",
                  "--decode-impl", "cuda", "--prefill-kernel", "cuda"])
    out = capsys.readouterr().out
    assert "completed 3 requests" in out
    assert "op/bucket decision table" in out
    for argv, item in ((["--swap"], "8(f)"), (["--mesh", "1,2"], "8(i)"),
                       (["--kv-layout", "auto"], "8(c)"),
                       (["--decode-horizon", "4"], "8(e)"), ([], "8(a)")):
        with pytest.raises(SystemExit):
            tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                          *(["--continuous"] if argv else []), *argv])
        assert f"item {item}" in capsys.readouterr().err


def test_port_imports_neither_jax_nor_repro():
    """In a fresh interpreter, importing the port and serving leaves no
    jax or repro module loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np, torch
        import repro_torch
        from repro_torch.configs import get_config
        from repro_torch.launch import serve
        from repro_torch.models import model
        from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request
        cfg = get_config("qwen3-8b").reduced()
        params = model.init_params(cfg, torch.Generator("cpu").manual_seed(0))
        eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=32,
                                       block_size=8, prefill_chunk=8,
                                       decode_impl="cuda", prefill_kernel="cuda",
                                       device="cpu")
        eng.submit(Request(rid=0, prompt=np.arange(9, dtype=np.int32),
                           max_new_tokens=3))
        assert len(eng.run()[0].out) == 3
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
