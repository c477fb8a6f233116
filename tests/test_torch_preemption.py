"""Page-pool pressure in the port's engine, against ``repro``.

tests/test_preemption.py case for case, each run on the JAX engine and on
the port's (``device="cpu"``) with the same ``page_budget``, priorities and
swap setting: greedy tokens equal (and equal to a lone ``ServeLoop``), the
ladder's counters equal (``preemptions``, ``decode_preemptions``,
``swap_outs``, ``swap_ins``, ``swapped_pages``, ``placement_rollbacks``,
``sched_skips``: host logic, deterministic), the page audit clean after
the drain.  Then what the port adds or must keep: rollbacks requeued at
the head of their class, TTFT recorded once, ``swap_out_pages`` /
``swap_in_pages`` bit-equal to the reference's on one pool, ``PagePool``'s
swap accounting, the constructor's validation, the SLO bucket keys and
labels, ``prefill_chunk="auto"`` on a fake clock, fused horizons and the
kernel variants under pressure, the decode buffers' addresses across
preemptions and swaps, and the launcher's new flags.  Reduced qwen3-8b
in f32, weights carried across with ``params_from_jax``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.core import bucket_label as j_bucket_label  # noqa: E402
from repro.core import slo_pressure_bucket as j_slo_bucket  # noqa: E402
from repro.core.shape_class import _split_slo as j_split_slo  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import page_pool as jpool  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (VPE, bucket_label, decode_horizon_bucket,  # noqa: E402
                              occupancy_bucket, prefill_chunk_bucket,
                              slo_pressure_bucket)
from repro_torch.core.shape_class import _split_slo  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import page_pool as tpool  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

torch.set_num_threads(1)
MAX_LEN = 64
COUNTERS = ("preemptions", "decode_preemptions", "swap_outs", "swap_ins",
            "swapped_pages", "placement_rollbacks", "sched_skips")


@pytest.fixture(scope="module")
def setup():
    cfg = ARCHS["qwen3-8b"].reduced()
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_config("qwen3-8b").reduced(), jp, tp


def engine(mod, setup, **kw):
    cfg, tcfg, jp, tp = setup
    kw = {"slots": 4, "max_len": MAX_LEN, "kv_layout": "paged", "block_size": 8,
          **kw}
    if mod is tserve:
        return tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    return jserve.ContinuousBatchingEngine(cfg, jp, **kw)


def greedy_refs(setup, prompts, max_new):
    """The port's unpressured reference: each prompt alone through
    ``ServeLoop.generate``."""
    _, tcfg, _, tp = setup
    serve = tserve.ServeLoop(tcfg, tp, max_len=MAX_LEN, batch=1, device="cpu")
    return [[int(t) for t in serve.generate({"tokens": p[None, :]}, max_new)[0]]
            for p in prompts]


def prompts_of(vocab, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def serve_both(setup, prompts, max_new, priority, **kw):
    """The same traffic on the JAX engine and the port's: returns {module:
    (engine, requests by rid)} after checking equal tokens and counters and
    a clean audit on both."""
    out = {}
    for mod in (jserve, tserve):
        eng = engine(mod, setup, **kw)
        for i, p in enumerate(prompts):
            eng.submit(mod.Request(rid=i, prompt=p, max_new_tokens=max_new,
                                   priority=priority(i)))
        done = sorted(eng.run(), key=lambda r: r.rid)
        assert len(done) == len(prompts)
        eng.check_kv()
        out[mod] = (eng, done)
    (jeng, jdone), (teng, tdone) = out[jserve], out[tserve]
    assert [[int(t) for t in r.out] for r in tdone] == \
        [[int(t) for t in r.out] for r in jdone]
    got = {c: getattr(teng.stats, c) for c in COUNTERS}
    want = {c: getattr(jeng.stats, c) for c in COUNTERS}
    assert got == want
    assert [r.preemptions for r in tdone] == [r.preemptions for r in jdone]
    return out


def alternate(i):
    return "interactive" if i % 2 == 0 else "batch"


# -- over-pressure: the acceptance workload ---------------------------------------

@pytest.mark.parametrize("swap", [False, True], ids=["recompute", "swap"])
def test_completes_with_parity_and_no_leaks(setup, swap):
    """A pool of 12 pages where the worst case is 40, mixed priorities:
    every request done with its unpressured tokens, the JAX engine's
    counters, preemption really exercised, and nothing leaked."""
    cfg = setup[0]
    prompts = prompts_of(cfg.vocab_size, 0, (8, 21, 13, 30, 17, 9, 25, 12))
    want = greedy_refs(setup, prompts, 10)
    out = serve_both(setup, prompts, 10, alternate, prefix_blocks=4,
                     page_budget=12, swap=swap)
    eng, done = out[tserve]
    for i, r in enumerate(done):
        assert r.status == "done", (i, r.status, r.error)
        assert r.out == want[i], f"request {i} diverged after preemption"
    assert eng.stats.preemptions > 0
    if swap:
        assert eng.stats.swap_outs > 0
        assert eng.stats.swap_ins == eng.stats.swap_outs
        assert len(eng.stats.swap_out_s) == eng.stats.swap_outs
        assert len(eng.stats.swap_in_s) == eng.stats.swap_ins
    for s in eng.slots:
        assert s.req is None and s.pages == []
    assert "preemptions" in eng.stats.summary()


def test_single_request_fits_at_the_floor(setup):
    """The floor (nb_max + 2) is enough for a lone max-size request."""
    cfg = setup[0]
    prompt = prompts_of(cfg.vocab_size, 5, (50,))
    want = greedy_refs(setup, prompt, 14)
    out = serve_both(setup, prompt, 14, lambda i: "batch", prefix_blocks=0,
                     page_budget=8 + 2)
    (r,) = out[tserve][1]
    assert r.out == want[0]


def test_preempted_request_records_ttft_once(setup):
    """Per-request records stay per request across re-admissions: one TTFT
    and one queue wait each, and ``first_logits`` keeps each request's
    first-token logits, not a resumed residency's."""
    cfg = setup[0]
    prompts = prompts_of(cfg.vocab_size, 1, (20, 28, 24, 30, 26, 22))
    out = serve_both(setup, prompts, 8, lambda i: "interactive" if i >= 4 else "batch",
                     prefix_blocks=2, page_budget=11, swap=True)
    for mod, (eng, done) in out.items():
        assert len(eng.stats.ttft_s) == len(prompts), mod.__name__
        assert len(eng.stats.queue_wait_s) == len(prompts)
        assert max(r.preemptions for r in done) >= 1
    # the same traffic with first_logits kept: one entry a request, whose
    # argmax is its first token
    eng = engine(tserve, setup, prefix_blocks=2, page_budget=11, swap=True)
    eng.first_logits = {}
    for i, p in enumerate(prompts):
        eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=8,
                                  priority="interactive" if i >= 4 else "batch"))
    done = eng.run()
    assert max(r.preemptions for r in done) >= 1
    assert sorted(eng.first_logits) == list(range(len(prompts)))
    for r in done:
        assert int(torch.argmax(eng.first_logits[r.rid])) == r.out[0]
        assert r.ttft_recorded and 0 <= r.queue_wait_s <= r.ttft_s


# -- placement rollback --------------------------------------------------------

def test_failed_placement_leaks_nothing(setup):
    """Placements that exhaust the ladder midway return every page they
    took (the audit would catch one leaked reference); this workload is
    known to hit the rollback path, on both engines alike."""
    cfg = setup[0]
    prompts = prompts_of(cfg.vocab_size, 3, (8, 21, 13, 30, 17, 9, 25, 12))
    want = greedy_refs(setup, prompts, 12)
    out = serve_both(setup, prompts, 12,
                     lambda i: "interactive" if i % 3 == 0 else "batch",
                     prefix_blocks=2, page_budget=11)
    eng, done = out[tserve]
    assert [r.out for r in done] == want
    assert eng.stats.placement_rollbacks > 0


def _fabricated(mod, setup, queue, req, budget=10):
    """An engine with ``queue`` waiting and ``req`` in slot 0, then rolled
    back by ``_unadmit``."""
    eng = engine(mod, setup, slots=2, prefix_blocks=0, page_budget=budget)
    eng.queue = list(queue)
    req.status = "running"
    eng.slots[0].req = req
    eng._unadmit(0, req)
    return eng


@pytest.mark.parametrize("case", ["at_head", "behind_better_class",
                                  "interactive_keeps_class_head"])
def test_unadmit_requeue_order_by_class(setup, case):
    """A rolled-back admission goes to the head of its own class: the front
    of the queue when nothing better waits, behind waiting interactive
    traffic and ahead of its batch peers, and an interactive one ahead of
    everything; the slot is free, the request queued, and nobody is charged
    a skip — the order the JAX engine gives."""
    orders = {}
    for mod in (jserve, tserve):
        inter = mod.Request(rid=1, prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=1, priority="interactive")
        peer = mod.Request(rid=2, prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=1, priority="batch")
        req = mod.Request(rid=0, prompt=np.arange(3, 15, dtype=np.int32),
                          max_new_tokens=2,
                          priority=("interactive" if case.startswith("inter")
                                    else "batch"))
        queue = {"at_head": [peer], "behind_better_class": [inter, peer],
                 "interactive_keeps_class_head": [peer]}[case]
        eng = _fabricated(mod, setup, queue, req)
        assert req.status == "queued" and eng.slots[0].req is None
        assert all(r.skips == 0 for r in eng.queue) and eng.stats.sched_skips == 0
        orders[mod] = [r.rid for r in eng.queue]
        eng.queue = []
        eng.check_kv()
    assert orders[tserve] == orders[jserve]
    assert orders[tserve] == {"at_head": [0, 2], "behind_better_class": [1, 0, 2],
                              "interactive_keeps_class_head": [0, 2]}[case]


# -- swap kernels and the pool's accounting ------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swap_roundtrip_equals_reference(dtype):
    """Three pages filled by the admission scatter (a partial tail block),
    swapped out, swapped into three other pages (padded with the trash id
    and a negative start), gathered again: on the port the round trip is
    exact, the swapped-out K/V and the whole pool after the swap-in equal
    the reference's bit for bit on the same inputs, and the pool keeps its
    addresses."""
    rng = np.random.default_rng(7)
    bs, n_pages, L, Hkv, D = 4, 8, 2, 2, 8
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jp = jkv.init_page_pool(n_pages, L, Hkv, bs, D, dtype=jdt)
    tp = tkv.init_page_pool(n_pages, L, Hkv, bs, D, dtype=tdt,
                            device=torch.device("cpu"))
    ptrs = [t.data_ptr() for t in tp.values()]
    ids = np.array([2, 5, 1], np.int32)
    starts = np.array([0, bs, 2 * bs], np.int32)
    k = rng.standard_normal((L, 1, Hkv, 3 * bs, D)).astype(np.float32)
    v = rng.standard_normal((L, 1, Hkv, 3 * bs, D)).astype(np.float32)
    filled = 3 * bs - 1                      # partial tail block
    jp = jkv.write_pages(jp, jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                         jnp.asarray(ids), jnp.asarray(starts), jnp.int32(0),
                         jnp.int32(filled))
    tkv.write_pages(tp, torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
                    torch.from_numpy(ids), torch.from_numpy(starts), 0, filled)
    pad_ids = np.array([2, 5, 1, 2], np.int32)        # padded by a repeat
    jk, jv = jkv.swap_out_pages(jp, jnp.asarray(pad_ids))
    tk, tv = tkv.swap_out_pages(tp, torch.from_numpy(pad_ids))
    for a, b in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    trash = n_pages
    new_ids = np.array([0, 3, 6, trash], np.int32)
    new_starts = np.array([0, bs, 2 * bs, -bs], np.int32)
    jp = jkv.swap_in_pages(jp, jk, jv, jnp.asarray(new_ids),
                           jnp.asarray(new_starts), jnp.int32(filled))
    tkv.swap_in_pages(tp, tk, tv, torch.from_numpy(new_ids),
                      torch.from_numpy(new_starts), filled)
    for key in "kv":
        np.testing.assert_array_equal(tp[key].float().numpy(),
                                      np.asarray(jp[key].astype(jnp.float32)))
    back_k, back_v = tkv.gather_pages(tp, torch.from_numpy(new_ids[:3]))
    assert torch.equal(back_k[..., :filled, :], tk[..., :filled, :])
    assert torch.equal(back_v[..., :filled, :], tv[..., :filled, :])
    assert [t.data_ptr() for t in tp.values()] == ptrs


def test_pool_swap_accounting_equals_reference():
    """``PagePool.swap_out`` frees only the private pages and
    ``swap_in`` is all or nothing, with the reference's counts."""
    seen = {}
    for mod in (jpool, tpool):
        pool = mod.PagePool(4)
        a, b = pool.alloc(), pool.alloc()
        pool.ref(a)                              # the tree co-owns a
        freed = pool.swap_out([a, b])
        rec = [freed, pool.refcount(a), pool.refcount(b), pool.swap_outs]
        pool.unref(a)
        pool.check()
        pool = mod.PagePool(3)
        held = [pool.alloc(), pool.alloc()]
        rec += [pool.swap_in(2), pool.num_free]
        got = pool.swap_in(1)
        rec += [got, pool.swap_ins]
        for pid in held + got:
            pool.unref(pid)
        pool.check()
        seen[mod] = rec
    assert seen[tpool] == seen[jpool]
    assert seen[tpool][:4] == [1, 1, 0, 1] and seen[tpool][4:6] == [None, 1]


# -- constructor validation ---------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(kv_layout="paged", page_budget=5), "page_budget"),       # floor is 10
    (dict(kv_layout="contiguous", page_budget=32), "paged"),
    (dict(slo_weight=-0.1), "slo_weight"),
    (dict(max_skip_by_class={"turbo": 1}), "max_skip_by_class")],
    ids=["budget_floor", "budget_needs_pages", "negative_slo_weight",
         "unknown_class"])
def test_constructor_validation(setup, kw, match):
    for mod in (jserve, tserve):
        with pytest.raises(ValueError, match=match):
            engine(mod, setup, slots=2, **{"block_size": 8, **kw})


def test_budget_at_the_floor_is_accepted(setup):
    eng = engine(tserve, setup, slots=2, page_budget=10)
    assert eng.pages.num_pages == 10
    assert eng.page_pool["k"].shape[1] == 11              # + the trash page


# -- keys and labels ------------------------------------------------------------------

def test_slo_bucket_and_labels_equal_reference():
    """``slo_pressure_bucket`` and ``bucket_label`` (reading the SLO tail
    of a composite key) give the reference's keys and labels."""
    for ni in range(-1, 5):
        for nb in range(-1, 8):
            assert slo_pressure_bucket(ni, nb) == j_slo_bucket(ni, nb)
    keys = [occupancy_bucket(3, 4), prefill_chunk_bucket(300, 2, 4),
            decode_horizon_bucket(5, 2, 4), ("plen", 0), ("scalar",)]
    for key in keys:
        for tail in ((), slo_pressure_bucket(0, 0), slo_pressure_bucket(1, 3),
                     slo_pressure_bucket(4, 9)):
            b = key + tail
            assert bucket_label(b) == j_bucket_label(b)
            assert _split_slo(b) == j_split_slo(b)
    assert bucket_label(slo_pressure_bucket(2, 1)) == j_bucket_label(
        j_slo_bucket(2, 1)) == "slo:i2b1"
    assert bucket_label(decode_horizon_bucket(3, 2, 4) + slo_pressure_bucket(1, 5)) \
        == "horizon:q[2,4)xocc2/4slotsxslo:i1b2"


# -- the measured chunk axis ------------------------------------------------------------

class _FakeClock:
    """``time`` for the engine module: every reading moves 1 ms on, so a
    prefill chunk's wall is 1 ms whatever its size."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t


def test_prefill_chunk_auto_on_a_fake_clock(setup, monkeypatch):
    """``prefill_chunk="auto"``: ``whole`` and the ``chunk_choices`` are
    registered, the controller trials each size in the prompts' bucket and
    concludes (on this clock whole wins: its one chunk costs least), and
    the tokens are those of ``whole``."""
    cfg = setup[0]
    prompts = prompts_of(cfg.vocab_size, 7, (48,) * 10)
    whole = engine(tserve, setup, slots=1, prefill_chunk="whole")
    for i, p in enumerate(prompts):
        whole.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=2))
    want = {r.rid: r.out for r in whole.run()}
    monkeypatch.setattr(tserve, "time", _FakeClock())
    vpe = VPE(controller_kwargs=dict(min_samples=2, trial_samples=2))
    eng = engine(tserve, setup, slots=1, prefill_chunk="auto",
                 chunk_choices=(8, 24), vpe=vpe)
    assert set(vpe.registry.op("prefill_chunk").variants) == {"whole", "8", "24"}
    assert vpe.registry.op("prefill_chunk").default == "whole"
    for i, p in enumerate(prompts):
        eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=2))
    assert {r.rid: r.out for r in eng.run()} == want
    d = vpe.controller.decision("prefill_chunk", prefill_chunk_bucket(48, 0, 1))
    assert set(d.tried) == {"whole", "8", "24"}
    events = [e for e, _, _ in d.history]
    assert events.count("trial") == 2 and events.count("revert") == 2
    assert d.selected == "whole"
    assert eng.stats.prefill_chunks > len(prompts)           # 8 and 24 chunked
    eng.check_kv()


def test_slo_weight_extends_the_keys(setup):
    """With ``slo_weight`` > 0 the horizon, chunk and prefill-kernel keys
    carry the queue's composition; without it they do not."""
    cfg = setup[0]
    prompts = prompts_of(cfg.vocab_size, 8, (20, 12, 30, 9, 17, 25))
    for w in (0.0, 0.5):
        vpe = VPE()
        eng = engine(tserve, setup, slots=2, prefill_chunk="auto",
                     decode_horizon="auto", slo_weight=w, vpe=vpe)
        for i, p in enumerate(prompts):
            eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=6,
                                      priority=alternate(i)))
        eng.run()
        for op in ("decode_horizon", "prefill_chunk", "prefill_kernel"):
            keys = vpe.profiler.buckets_seen(op)
            assert keys, op
            assert all((_split_slo(b)[1] is not None) == (w > 0) for b in keys), op


# -- fused horizons, the kernel variants and the prefix cache under pressure ---------

@pytest.mark.parametrize("swap", [False, True], ids=["recompute", "swap"])
def test_fused_horizon_under_pressure_equals_reference(setup, swap):
    """At H = 4 a horizon reserves its pages up front, so growth preempts
    (itself included) before the call: the JAX engine's tokens and
    counters, and the unpressured tokens."""
    cfg = setup[0]
    prompts = prompts_of(cfg.vocab_size, 9, (8, 21, 13, 30, 17, 9))
    want = greedy_refs(setup, prompts, 12)
    out = serve_both(setup, prompts, 12, alternate, page_budget=11,
                     decode_horizon=4, swap=swap)
    eng, done = out[tserve]
    assert [r.out for r in done] == want
    assert eng.stats.decode_preemptions > 0 and eng.stats.horizon_calls > 0


@pytest.mark.parametrize("swap", [False, True], ids=["recompute", "swap"])
def test_kernel_variants_under_pressure(setup, swap):
    """The kernels' plain versions (``cuda`` pinned) resume mid-block from a
    swap and through one-token recompute chunks: the tokens of the gather
    path under the same pressure, and the JAX engine's counters."""
    cfg = setup[0]
    prompts = prompts_of(cfg.vocab_size, 10, (8, 21, 13, 30, 17, 9, 25, 12))
    gather = serve_both(setup, prompts, 10, alternate, prefix_blocks=4,
                        page_budget=12, swap=swap, prefill_chunk=8)
    eng = engine(tserve, setup, prefix_blocks=4, page_budget=12, swap=swap,
                 prefill_chunk=8, decode_impl="cuda", prefill_kernel="cuda")
    for i, p in enumerate(prompts):
        eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=10,
                                  priority=alternate(i)))
    done = sorted(eng.run(), key=lambda r: r.rid)
    eng.check_kv()
    assert [r.out for r in done] == [r.out for r in gather[tserve][1]]
    assert eng.stats.preemptions == gather[tserve][0].stats.preemptions > 0


def test_prefix_cache_under_pressure_equals_reference(setup):
    """Shared prompts with a warm tree under a small budget: eviction,
    preemption and swap interleave with aliasing and copy-on-write; the
    JAX engine's tokens, counters and prefix counts."""
    cfg = setup[0]
    rng = np.random.default_rng(11)
    system = rng.integers(0, cfg.vocab_size, 19).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, n)
                               .astype(np.int32)]) for n in (3, 9, 14, 5, 11, 7)]
    out = serve_both(setup, prompts, 10, alternate, prefix_blocks=6,
                     page_budget=12, swap=True)
    (jeng, _), (teng, _) = out[jserve], out[tserve]
    pre = ("prefix_lookups", "prefix_hits", "prefix_tokens_saved", "cow_copies",
           "paged_admits")
    assert [getattr(teng.stats, c) for c in pre] == [getattr(jeng.stats, c) for c in pre]
    assert teng.stats.preemptions > 0 and teng.stats.prefix_hits > 0


def test_priority_admission_and_class_skip_budgets(setup):
    """Interactive requests go first in the admission window, and a batch
    request jumped its class's budget goes next: the JAX engine's
    admission order and skip counts."""
    cfg = setup[0]
    prompts = prompts_of(cfg.vocab_size, 12, (9, 7, 12, 5, 10, 8, 6, 11))

    def prio(i):
        return "batch" if i < 3 else "interactive"

    out = serve_both(setup, prompts, 3, prio, slots=1,
                     max_skip_by_class={"batch": 2, "interactive": 8})
    orders = {mod: [r.rid for r in sorted(done, key=lambda r: r.admit_step)]
              for mod, (_, done) in out.items()}
    assert orders[tserve] == orders[jserve]
    assert out[tserve][0].stats.sched_skips > 0


# -- static addresses --------------------------------------------------------------

def test_decode_buffers_keep_their_addresses_under_pressure(setup):
    """Preemption, swap-in and rollback write the decode inputs, block
    table, lengths and pool in place: their data pointers never move over a
    run that preempts (decoding slots among them) and swaps, at H = 4."""
    cfg = setup[0]
    eng = engine(tserve, setup, page_budget=11, swap=True, decode_horizon=4)

    def pointers():
        g = eng.graphs
        tensors = [eng._inputs, g.tok, g.live, g.eos, g.paged, g.budget,
                   *eng.cache.values(), eng.page_pool["k"], eng.page_pool["v"]]
        return [t.data_ptr() for t in tensors]

    before = pointers()
    graphs = eng.graphs
    for i, p in enumerate(prompts_of(cfg.vocab_size, 9, (8, 21, 13, 30, 17, 9))):
        eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=12,
                                  priority=alternate(i)))
    while eng.queue or eng.num_active:
        eng.step()
        assert pointers() == before
        assert eng.graphs is graphs and graphs.cache is eng.cache \
            and graphs.pool is eng.page_pool
    st = eng.stats
    assert st.decode_preemptions > 0 and st.swap_ins == st.swap_outs > 0
    assert eng.pages.drained


# -- the launcher ---------------------------------------------------------------------

def test_launcher_pressure_flags(capsys):
    """``--page-budget --swap --priority mix --prefill-chunk auto`` serve on
    the CPU: the summary counts the preemptions and swaps, and the decision
    table lists the chunk axis."""
    tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--continuous", "--device",
                  "cpu", "--kv-layout", "paged", "--max-len", "64",
                  "--block-size", "8", "--requests", "6", "--new-tokens", "12",
                  "--prompt-len", "20", "--page-budget", "11", "--swap",
                  "--priority", "mix", "--prefill-chunk", "auto",
                  "--slo-weight", "0.5"])
    out = capsys.readouterr().out
    assert "completed 6 requests" in out
    assert "preemptions" in out and "swaps out/in" in out
    assert "prefill_chunk" in out
