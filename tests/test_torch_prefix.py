"""The port's shared-prefix KV cache in the engine, against ``repro``.

The scenarios of tests/test_prefix_cache.py and tests/test_paged_kv.py on
the port: on each layout (contiguous, paged, ``auto``) a warm admission
gives the tokens of a cold ``ServeLoop.generate`` and of the JAX engine on
the same traffic, with the reference's hit, saving and copy-on-write
counts; a mid-stream eviction, a copy-on-write tail shared by two resident
requests, an identical re-serve, the ``recompute`` variant and ``auto``'s
forced layout flip leave every request's tokens unchanged; a drain leaves
no pin and only tree pages; the prefix-aware scheduler jumps a request at
most ``max_skip`` times; a placement the pool cannot finish rolls back
every reference it took; the ``prefix_reuse`` and ``kv_layout`` axes trial
both variants.  Reduced qwen3-8b in f32, weights carried across with
``params_from_jax``; tokens compared exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.core import VPE as JVPE  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (VPE, kv_layout_bucket, kv_layout_buckets,  # noqa: E402
                              prefix_len_bucket)
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

torch.set_num_threads(1)
MAX_LEN, BS = 64, 8
LAYOUTS = ["contiguous", "paged", "auto"]


@pytest.fixture(scope="module")
def setup():
    cfg = ARCHS["qwen3-8b"].reduced()
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_config("qwen3-8b").reduced(), jp, tp


def cold_greedy(setup, prompt, max_new):
    """The port's cold reference: one prompt through ServeLoop.generate."""
    _, tcfg, _, tp = setup
    serve = tserve.ServeLoop(tcfg, tp, max_len=MAX_LEN, batch=1, device="cpu")
    return [int(t) for t in serve.generate({"tokens": prompt[None, :]}, max_new)[0]]


def engine(mod, setup, **kw):
    cfg, tcfg, jp, tp = setup
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("block_size", BS)
    kw.setdefault("prefix_blocks", 16)
    kw.setdefault("prefill_kernel", "gather")
    if mod is tserve:
        return tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    return jserve.ContinuousBatchingEngine(cfg, jp, **kw)


def serve(eng, mod, prompts, max_new, rid0=0):
    for i, p in enumerate(prompts):
        eng.submit(mod.Request(rid=rid0 + i, prompt=p, max_new_tokens=max_new))
    done = sorted((r for r in eng.run() if rid0 <= r.rid < rid0 + len(prompts)),
                  key=lambda r: r.rid)
    return [[int(t) for t in r.out] for r in done]


def shared_prompts(vocab, seed, prefix, tails):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, prefix).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, n).astype(np.int32)])
            for n in tails]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_warm_matches_cold_and_reference(setup, layout):
    """A cold pass caches the blocks of a prompt whose first 29 tokens
    are shared (3 full blocks and 5 tokens of a fourth); three warm
    requests then give the cold tokens and the JAX engine's, with its
    lookup, hit, saved-token and copy-on-write counts (paged: a fourth
    block's 5 shared tokens are matched and cloned).  A drain leaves no
    pin, and every pool reference is the tree's."""
    cfg = setup[0]
    prompts = shared_prompts(cfg.vocab_size, 0, 29, (5, 9, 3))
    refs = [cold_greedy(setup, p, 6) for p in prompts]
    stats = {}
    for mod in (jserve, tserve):
        eng = engine(mod, setup, kv_layout=layout)
        serve(eng, mod, prompts[:1], 6, rid0=100)
        got = serve(eng, mod, prompts, 6)
        assert got == refs, f"{mod.__name__} {layout}"
        eng.check_kv()
        assert eng.prefix_cache.total_refcount() == 0
        st = eng.stats
        stats[mod] = (st.prefix_lookups, st.prefix_hits, st.prefix_tokens_saved,
                      st.cow_copies, st.paged_admits)
    assert stats[tserve] == stats[jserve]
    lookups, hits, saved, cow, _ = stats[tserve]
    assert (lookups, hits) == (4, 3) and saved >= 3 * 24
    assert (cow > 0) == (layout == "paged")
    if layout != "contiguous":
        assert all(not s.pages for s in eng.slots)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_parity_across_midstream_eviction(setup, layout):
    """Evicting every unpinned tree page while a warm request decodes
    cannot change its tokens: its own path is pinned (and, paged, its
    aliased pages keep the pool's reference)."""
    cfg = setup[0]
    rng = np.random.default_rng(2)
    a = rng.integers(0, cfg.vocab_size, 34).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, 34).astype(np.int32)
    ref = cold_greedy(setup, a, 12)
    eng = engine(tserve, setup, kv_layout=layout, prefix_blocks=8)
    serve(eng, tserve, [a, b], 2, rid0=100)
    eng.submit(tserve.Request(rid=0, prompt=a, max_new_tokens=12))
    for _ in range(4):                 # admit (warm), then a few decode steps
        assert eng.step()
    live = next(s.req for s in eng.slots if s.req is not None)
    pinned = set(live.cache_handle.block_ids)
    assert eng.prefix_cache.evict(10 ** 6) > 0
    assert not (pinned & set(eng.prefix_cache.free)), "pinned pages freed"
    eng.check_kv()
    (r,) = (r for r in eng.run() if r.rid == 0)
    assert r.out == ref
    eng.check_kv()
    assert eng.prefix_cache.total_refcount() == 0


def test_cow_tail_isolation_between_prefix_sharers(setup):
    """Paged: two resident requests share a prefix ending inside a cached
    block; the truncated one aliases the full blocks and clones that block
    copy-on-write, so its writes cannot reach the block the other aliases
    — both give their cold tokens, and a third serving of the full prompt
    too."""
    cfg = setup[0]
    rng = np.random.default_rng(3)
    template = rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
    trunc = template[:29].copy()                 # ends mid-block 3
    ref_full, ref_trunc = cold_greedy(setup, template, 8), cold_greedy(setup, trunc, 8)
    eng = engine(tserve, setup, kv_layout="paged")
    serve(eng, tserve, [template], 2, rid0=100)  # blocks 0..3 cached
    assert serve(eng, tserve, [template, trunc], 8) == [ref_full, ref_trunc]
    assert eng.stats.cow_copies >= 1 and eng.prefix_cache.stats.partial_hits >= 1
    assert serve(eng, tserve, [template], 8, rid0=10) == [ref_full]
    eng.check_kv()


def test_identical_reserve_uses_partial_tail(setup):
    """Paged: re-serving an identical prompt matches all but its last
    token (the partial tail), so one token is prefilled."""
    cfg = setup[0]
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 40).astype(np.int32)
    ref = cold_greedy(setup, prompt, 5)
    eng = engine(tserve, setup, kv_layout="paged")
    serve(eng, tserve, [prompt], 5, rid0=100)
    assert serve(eng, tserve, [prompt], 5) == [ref]
    assert eng.stats.cow_copies == 1 and eng.stats.prefix_tokens_saved == 39
    eng.check_kv()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_recompute_variant_parity(setup, layout):
    """Forcing ``prefix_reuse`` to ``recompute`` serves the same tokens:
    the hit is counted, no token is saved."""
    cfg = setup[0]
    (prompt,) = shared_prompts(cfg.vocab_size, 5, 24, (6,))
    ref = cold_greedy(setup, prompt, 5)
    vpe = VPE()
    eng = engine(tserve, setup, kv_layout=layout, vpe=vpe, decode_impl="grouped")
    serve(eng, tserve, [prompt], 5, rid0=100)
    for m in (24, 29):
        vpe.controller.force("prefix_reuse", prefix_len_bucket(m), "recompute")
    assert serve(eng, tserve, [prompt], 5) == [ref]
    assert eng.stats.prefix_hits == 1 and eng.stats.prefix_tokens_saved == 0
    eng.check_kv()


def test_auto_forced_flip_equals_reference(setup):
    """``auto`` with paged forced for every warm bucket: cold admissions
    are contiguous, warm ones paged, so decode calls mix both layouts; the
    tokens are the cold ones and the JAX engine's under the same forcing."""
    cfg = setup[0]
    prompts = shared_prompts(cfg.vocab_size, 6, 24, (4, 5, 6, 7))
    refs = [cold_greedy(setup, p, 8) for p in prompts]
    for mod, vpe in ((jserve, JVPE()), (tserve, VPE())):
        eng = engine(mod, setup, kv_layout="auto", vpe=vpe, decode_impl="grouped")
        serve(eng, mod, prompts[:1], 8, rid0=100)
        for bucket in kv_layout_buckets(40, 2):
            vpe.controller.force("kv_layout", bucket, "paged")
        assert serve(eng, mod, prompts, 8) == refs, mod.__name__
        assert eng.stats.paged_admits == 4
        eng.check_kv()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_no_leaked_pins_after_drain(setup, layout):
    """Six requests over a shared 8-token prefix with budgets of 1–3: after
    the drain no handle or pin is left, slots hold no pages, the audit is
    clean, and a full eviction empties the tree (and the pool)."""
    cfg = setup[0]
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    eng = engine(tserve, setup, kv_layout=layout, prefix_blocks=6)
    for i in range(6):
        tail = rng.integers(0, cfg.vocab_size, 3 + i).astype(np.int32)
        eng.submit(tserve.Request(rid=i, prompt=np.concatenate([shared, tail]),
                                  max_new_tokens=1 + i % 3))
    done = eng.run()
    assert len(done) == 6 and all(r.cache_handle is None for r in done)
    assert all(s.free and not s.pages for s in eng.slots)
    eng.check_kv()
    assert eng.prefix_cache.total_refcount() == 0
    eng.prefix_cache.evict(10 ** 6)
    assert eng.prefix_cache.live_blocks == 0
    if eng.pages is not None:
        assert eng.pages.drained
    eng.check_kv()


def test_max_skip_bound_equals_reference(setup):
    """One slot, a cached prefix, and the queue: one request with no match
    ahead of five that match.  Prefix-aware admission jumps it, at most
    ``max_skip`` = 2 times; the admission order, the skip count and the
    tokens are the JAX engine's."""
    cfg = setup[0]
    hot = shared_prompts(cfg.vocab_size, 8, 24, (3, 4, 5, 6, 7, 8))
    cold = np.random.default_rng(9).integers(0, cfg.vocab_size, 20).astype(np.int32)
    out = {}
    for mod in (jserve, tserve):
        eng = engine(mod, setup, kv_layout="paged", slots=1, max_skip=2)
        serve(eng, mod, hot[:1], 2, rid0=100)
        eng.submit(mod.Request(rid=0, prompt=cold, max_new_tokens=2))
        for i, p in enumerate(hot[1:]):
            eng.submit(mod.Request(rid=1 + i, prompt=p, max_new_tokens=2))
        done = [r for r in eng.run() if r.rid < 100]
        out[mod] = ([r.rid for r in done], eng.stats.sched_skips,
                    {r.rid: [int(t) for t in r.out] for r in done})
        eng.check_kv()
    assert out[tserve] == out[jserve]
    order, skips, _ = out[tserve]
    assert order.index(0) == 2 and skips >= 2


@pytest.mark.parametrize("axis", ["prefix_reuse", "kv_layout"])
def test_measured_axis_trials_both_variants(setup, axis):
    """Ten warm admissions in one bucket: the controller trials the other
    variant and concludes (switch or revert) — on ``prefix_reuse``
    (contiguous) and on ``kv_layout`` (``auto``, one slot)."""
    cfg = setup[0]
    prompts = shared_prompts(cfg.vocab_size, 10, 32, (4,) * 11)
    vpe = VPE(controller_kwargs=dict(min_samples=2, trial_samples=2))
    layout = "contiguous" if axis == "prefix_reuse" else "auto"
    eng = engine(tserve, setup, kv_layout=layout, vpe=vpe, slots=1,
                 decode_impl="grouped")
    serve(eng, tserve, prompts, 2)
    bucket = (prefix_len_bucket(32) if axis == "prefix_reuse"
              else kv_layout_bucket(32, 0, 1))
    d = vpe.controller.decision(axis, bucket)
    assert set(d.tried) == set(tserve.SERVE_AXES[axis])
    events = [e for e, _, _ in d.history]
    assert "trial" in events and ("switch" in events or "revert" in events)
    eng.check_kv()


def test_placement_rolls_back_all_or_nothing(setup):
    """Paged: the pool gives out one page and then none while a warm
    admission is placed (its match pinned, so eviction frees nothing): the
    placement returns every reference it took — aliased pages and the
    fresh one — the request goes back to the queue head with its queue
    record kept, and it is served with its cold tokens once pages
    return."""
    cfg = setup[0]
    prompts = shared_prompts(cfg.vocab_size, 11, 24, (20,))
    ref = cold_greedy(setup, prompts[0], 4)
    eng = engine(tserve, setup, kv_layout="paged")
    serve(eng, tserve, [prompts[0][:26]], 2, rid0=100)   # 3 full blocks cached
    refs = list(eng.pages.refs)
    alloc, given = eng.pages.alloc, []

    def scarce():
        if given:
            return None
        given.append(alloc())
        return given[-1]

    eng.pages.alloc = scarce
    eng.submit(tserve.Request(rid=0, prompt=prompts[0], max_new_tokens=4))
    eng.step()
    assert given and eng.stats.placement_rollbacks == 1
    assert eng.pages.refs == refs and [r.rid for r in eng.queue] == [0]
    assert eng.num_active == 0 and eng.prefix_cache.total_refcount() == 0
    eng.check_kv()
    del eng.pages.alloc
    assert serve(eng, tserve, [], 4) == [] and len(eng.stats.queue_wait_s) == 2
    (r,) = (r for r in eng.completed if r.rid == 0)
    assert r.out == ref and eng.stats.prefix_hits == 2
    eng.check_kv()
