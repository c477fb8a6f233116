"""The port's profiler ranges on the CPU: ``core.spans.span`` enters
``record_function`` only while a profiler records; the serving engine's
phases (``serve.admit``, ``serve.prefill_chunk``, ``serve.decode`` and its
``prepare`` / ``launch`` / ``commit`` children) and the training step's
three ranges appear under ``torch.profiler``, nested and disjoint as
documented; and ``ServeStats.prefill_wait_s`` holds one entry per first
token, each request's own."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.spans import span  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402

torch.set_num_threads(1)
ENGINE = dict(slots=2, max_len=48, block_size=8, kv_layout="paged")
PHASES = ("serve.admit", "serve.prefill_chunk", "serve.decode")
CHILDREN = ("serve.decode.prepare", "serve.decode.launch", "serve.decode.commit")
TRAIN_RANGES = ("train_step.loss_and_grads", "train_step.optimizer",
                "attention_flash.backward")


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3-8b").reduced()
    return cfg, tmodel.init_params(cfg, torch.Generator().manual_seed(0))


def _engine(setup, **kw):
    cfg, params = setup
    return tserve.ContinuousBatchingEngine(cfg, params, device="cpu",
                                           **{**ENGINE, **kw})


def _request(rid, n, vocab, new=6):
    rng = np.random.default_rng(rid)
    return tserve.Request(rid=rid, prompt=rng.integers(0, vocab, n).astype(np.int32),
                          max_new_tokens=new)


@pytest.fixture
def entries(monkeypatch):
    """Counts every entry into ``record_function``, whoever imported it."""
    count = [0]
    real = autograd_profiler.record_function.__enter__

    def counting(self):
        count[0] += 1
        return real(self)

    monkeypatch.setattr(autograd_profiler.record_function, "__enter__", counting)
    return count


def _spans(prof):
    """{name: [(start us, end us)]} of the host events of the port's ranges."""
    out = {}
    for e in prof.events():
        if e.name in PHASES + CHILDREN + TRAIN_RANGES:
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def test_span_is_a_shared_noop_without_a_profiler():
    assert span("a") is span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("a"), autograd_profiler.record_function)
    assert span("a") is span("b")


@pytest.mark.parametrize("spec_draft", ["off", 2])
def test_engine_step_records_its_phases(setup, spec_draft):
    """One step with a queued prompt beside a decoding slot: the admission,
    the prefill chunk and the decode call (a verify call under speculation)
    each record their range; the decode call's three children nest inside
    it, and no two ranges of one level overlap."""
    eng = _engine(setup, prefill_chunk=8, spec_draft=spec_draft,
                  decode_impl="grouped", prefill_kernel="gather")
    vocab = setup[0].vocab_size
    eng.submit(_request(1, 11, vocab, new=12))
    while eng.queue or any(s.prefilling for s in eng.slots):
        eng.step()
    assert eng.num_decoding == 1
    eng.submit(_request(2, 13, vocab))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    got = _spans(prof)
    assert all(len(got.get(n, [])) == 1 for n in PHASES + CHILDREN), got
    (d0, d1), = got["serve.decode"]
    for n in CHILDREN:
        (a, b), = got[n]
        assert d0 <= a <= b <= d1
    for level in (PHASES, CHILDREN):
        ivs = sorted(got[n][0] for n in level)
        assert all(b <= a for (_, b), (a, _) in zip(ivs, ivs[1:])), ivs
    # the order the step runs them in
    assert [n for _, n in sorted((got[n][0][0], n) for n in PHASES)] == list(PHASES)
    assert [n for _, n in sorted((got[n][0][0], n) for n in CHILDREN)] == list(CHILDREN)
    eng.run()
    eng.check_kv()


def test_engine_enters_no_range_without_a_profiler(setup, entries):
    eng = _engine(setup, prefill_chunk=4, decode_impl="cuda", prefill_kernel="cuda")
    vocab = setup[0].vocab_size
    for rid in range(4):
        eng.submit(_request(rid, 5 + 2 * rid, vocab))
    eng.run()
    assert len(eng.completed) == 4 and eng.stats.decode_steps > 0
    assert entries[0] == 0
    # the counter sees the engine's ranges once a profiler records
    eng.submit(_request(9, 7, vocab))
    with profile(activities=[ProfilerActivity.CPU]):
        eng.run()
    assert entries[0] >= len(PHASES) + len(CHILDREN)


@pytest.mark.parametrize("kw", [dict(prefill_chunk=4, chunks_per_step=1),
                                dict(prefill_chunk=4, chunks_per_step=2),
                                dict(kv_layout="contiguous")])
def test_prefill_wait_is_each_requests_own(setup, kw):
    """One entry per first token, each >= 0 and each its request's; a
    request waits at most from its admission to its first token, and a
    contiguous admission, prefilled at once, waits 0."""
    eng = _engine(setup, **kw)
    vocab = setup[0].vocab_size
    reqs = [_request(rid, 6 + 3 * rid, vocab) for rid in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    eng.check_kv()
    st = eng.stats
    assert len(st.prefill_wait_s) == len(st.ttft_s) == len(reqs)
    assert sorted(st.prefill_wait_s) == sorted(r.prefill_wait_s for r in reqs)
    for r in reqs:
        assert 0.0 <= r.prefill_wait_s <= r.ttft_s - r.queue_wait_s
    if kw.get("kv_layout") == "contiguous":
        assert st.prefill_wait_s == [0.0] * len(reqs)
    else:
        # two slots, one chunk a step: a later slot's chunks wait their turn
        assert max(st.prefill_wait_s) > 0.0


def test_prefill_wait_of_a_lone_request(setup):
    """Admitted alone and prefilled in one chunk: its wait is only the
    engine's own work between the placement, the chunk and the token."""
    eng = _engine(setup, prefill_chunk=16)
    r = _request(3, 9, setup[0].vocab_size)
    eng.submit(r)
    eng.run()
    assert eng.stats.prefill_chunks == 1
    (w,) = eng.stats.prefill_wait_s
    assert w == r.prefill_wait_s and 0.0 <= w <= r.ttft_s - r.queue_wait_s


def test_merged_stats_concatenate_prefill_waits():
    a, b = tserve.ServeStats(prefill_wait_s=[0.1]), tserve.ServeStats(prefill_wait_s=[0.2, 0.0])
    assert tserve._merge_stats([a, b]).prefill_wait_s == [0.1, 0.2, 0.0]


@pytest.mark.parametrize("profiled", [False, True])
def test_train_step_ranges_keep_their_names(entries, profiled):
    """The training step's ranges, read by ``optimizer_ms`` and
    ``attn_backward_ms``: under the profiler each is recorded under its
    name; without one no range is entered."""
    cfg = get_config("h2o-danube-3-4b").reduced()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    step = ttrain.make_train_step(cfg, adamw.AdamWConfig(),
                                  impl={"attn_impl": "flash_cuda"})
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int64))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    ctx = profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext()
    with ctx as prof:
        step(params, ttrain.init_opt_state(adamw.AdamWConfig(), params), batch, 1e-3)
    if not profiled:
        assert entries[0] == 0
        return
    got = _spans(prof)
    assert all(got.get(n) for n in TRAIN_RANGES), got
    (l0, l1), = got["train_step.loss_and_grads"]
    assert all(l0 <= a <= b <= l1 for a, b in got["attention_flash.backward"])
    (o0, _), = got["train_step.optimizer"]
    assert l1 <= o0
