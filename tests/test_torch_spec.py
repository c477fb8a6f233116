"""Speculative decoding of the port against ``repro`` (after
tests/test_spec_decode.py): ``_spec_accept`` on seeded random inputs, EOS
mid-span and budgets below the span included, exactly; the verify
functions' logits, tokens, valid masks, final tokens, lengths and pools;
``append_tokens_paged``, ``update_layer_cache_multi`` and
``spec_verify_attention``; the engine against the JAX engine on the same
requests — tokens and the spec counters equal on the paged and ``auto``
layouts at S in {4, 16}; the resolution to ``off``; the rejected tail's
page rollback; the proposer; and the measured ``spec_draft`` axis backing
off on adversarial traffic, decided on walls from an injected clock.

Reduced qwen3-8b in f32, weights carried across with ``params_from_jax``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (VPE, accept_rate_level, bucket_label,  # noqa: E402
                              kv_layout_bucket, spec_accept_bucket)
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime.spec_decode import NGramProposer  # noqa: E402

torch.set_num_threads(1)
MAX_LEN = 64
# f32 computed by two libraries: the verify pass's logits; the K/V it
# writes (tests/test_torch_horizon.py's limit for the pages after a fused
# call); the span writes and the verify attention on equal inputs
LOGIT_TOL = dict(rtol=0, atol=1e-5)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
FN_TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    cfg = ARCHS["qwen3-8b"].reduced()
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_config("qwen3-8b").reduced(), jp, tp


# -- the accept mask ---------------------------------------------------------

@pytest.mark.parametrize("S", [1, 4, 16])
def test_spec_accept_equals_reference(S):
    """Seeded random spans where drafts match ``g`` for a random prefix
    length, EOS ids that fall inside and outside the accepted run, budgets
    from 0 to past S and dead slots: valid, n_emit and final exactly."""
    rng = np.random.default_rng(S)
    B, V = 64, 7
    g = rng.integers(0, V, (B, S)).astype(np.int32)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    n_match = rng.integers(0, S, B)
    for b in range(B):
        tokens[b, 1:1 + n_match[b]] = g[b, :n_match[b]]
    live = (rng.random(B) < 0.85).astype(np.int32)
    budget = rng.integers(0, S + 3, B).astype(np.int32)
    eos = np.where(rng.random(B) < 0.5, rng.integers(0, V, B), -1).astype(np.int32)
    jv, jn, jf = jtr._spec_accept(*(jnp.asarray(a) for a in
                                    (tokens, g, live, eos, budget)))
    tv, tn, tf = ttr._spec_accept(*(torch.from_numpy(a) for a in
                                    (tokens, g, live, eos, budget)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # the draws reach every case: an EOS inside the accepted run, a budget
    # below the span, a dead slot
    assert (budget < S).any() and (live == 0).any()
    if S > 1:
        stopped = ((np.asarray(jv).sum(1) < np.minimum(budget, n_match + 1))
                   & (live > 0))
        assert stopped.any()


# -- the verify functions -----------------------------------------------------

BS, NB, PAGES = 8, 6, 20


class _LogitSpy:
    """Stands in for ``jnp`` in the reference's transformer module: the
    verify functions pass their logits to ``jnp.argmax`` once, and the spy
    keeps them."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, x, axis=None):
        self.logits = np.asarray(x)
        return jnp.argmax(x, axis=axis)


def _verify_inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, PAGES + 1, cfg.num_kv_heads, BS, cfg.head_dim)
    pool = {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}
    slot_shape = (cfg.num_layers, 3, cfg.num_kv_heads, NB * BS, cfg.head_dim)
    slot = {k: rng.standard_normal(slot_shape).astype(np.float32) for k in "kv"}
    bt = rng.permutation(PAGES)[:3 * NB].reshape(3, NB).astype(np.int32)
    # slot 1 ends its budget one position short of max_len
    length = np.array([13, NB * BS - 3, 5], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (3, S)).astype(np.int32)
    live = np.array([1, 1, 0], np.int32)
    budget = np.array([S, 2, 0], np.int32)
    return pool, slot, bt, length, tokens, live, budget


@pytest.mark.parametrize("layout", ["paged", "mixed"])
@pytest.mark.parametrize("S", [4, 16])
def test_spec_verify_equals_reference(setup, monkeypatch, layout, S):
    """One verify call: the logits of the written rows within 1e-5 of the
    reference's; the committed tokens, valid mask and final tokens exactly; the lengths moved in place
    by the emitted count; the pages (and, mixed, the slot cache) within
    KV_TOL — the trash row never compared.  Slot 0's drafts are the target's
    own argmax (found by calling the port's scoring again), so its whole span
    lands; slot 1's too, and it stops on its budget of 2; slot 2 is not
    live."""
    cfg, tcfg, jp, tp = setup
    pool, slot, bt, length, tokens, live, budget = _verify_inputs(cfg, S, S)
    use_paged = np.array([1, 0, 1], np.int32)
    eos = np.full(3, -1, np.int32)

    def jax_call(toks):
        spy = _LogitSpy()
        monkeypatch.setattr(jtr, "jnp", spy)
        jpool = {k: jnp.asarray(v) for k, v in pool.items()}
        cache = {"bt": jnp.asarray(bt), "length": jnp.asarray(length)}
        args = (jnp.asarray(toks), jnp.asarray(live), jnp.asarray(eos),
                jnp.asarray(budget))
        if layout == "paged":
            jpool, cache, g, valid, final = jmodel.spec_verify_paged(
                cfg, jp, jpool, cache, *args)
        else:
            cache = {**{k: jnp.asarray(v) for k, v in slot.items()}, **cache}
            cache, jpool, g, valid, final = jmodel.spec_verify_mixed(
                cfg, jp, cache, jpool, args[0], jnp.asarray(use_paged), *args[1:])
        monkeypatch.setattr(jtr, "jnp", jnp)
        return spy.logits, jpool, cache, g, valid, final

    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    tcache = {"bt": torch.from_numpy(bt.copy()),
              "length": torch.from_numpy(length.copy())}
    if layout == "mixed":
        tcache.update({k: torch.from_numpy(v.copy()) for k, v in slot.items()})
    tuse = torch.from_numpy(use_paged)

    def port_logits(toks):
        args = (torch.from_numpy(toks), torch.from_numpy(live),
                torch.from_numpy(budget))
        pool_c = {k: v.clone() for k, v in tpool.items()}
        cache_c = {k: v.clone() for k, v in tcache.items()}
        if layout == "paged":
            return ttr.spec_verify_logits_paged(tcfg, tp, pool_c, cache_c, *args)
        return ttr.spec_verify_logits_mixed(tcfg, tp, cache_c, pool_c, args[0],
                                            tuse, *args[1:])

    for _ in range(S - 1):                     # draft j fixes argmax j
        tokens[:2, 1:] = port_logits(tokens).argmax(-1).numpy()[:2, :-1]
    jlogits, jpool, jcache, jg, jvalid, jfinal = jax_call(tokens)
    logits = port_logits(tokens)
    length_buf = tcache["length"]
    targs = [torch.from_numpy(a) for a in (tokens, live, budget)]
    if layout == "paged":
        tpool, tcache, tg, tvalid, tfinal = tmodel.spec_verify_paged(
            tcfg, tp, tpool, tcache, targs[0], targs[1], torch.from_numpy(eos),
            targs[2])
    else:
        tcache, tpool, tg, tvalid, tfinal = tmodel.spec_verify_mixed(
            tcfg, tp, tcache, tpool, targs[0], tuse, targs[1],
            torch.from_numpy(eos), targs[2])
        for k in "kv":
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                       **KV_TOL)
    # rows past a slot's budget and dead slots are garbage by contract
    # (their writes go nowhere, their tokens are never committed), and a
    # row past max_len attends to whatever the pages hold: compare the
    # written rows' logits and the committed tokens
    real = (live[:, None] > 0) & (np.arange(S)[None, :] < budget[:, None])
    np.testing.assert_allclose(logits.numpy()[real], jlogits[real], **LOGIT_TOL)
    jvalid = np.asarray(jvalid)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    np.testing.assert_array_equal(tg.numpy() * jvalid, np.asarray(jg) * jvalid)
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    assert tcache["length"] is length_buf                  # moved in place
    np.testing.assert_array_equal(length_buf.numpy(), np.asarray(jcache["length"]))
    assert tvalid.numpy().sum(1).tolist() == [S, 2, 0]
    for k in "kv":
        np.testing.assert_allclose(tpool[k][:, :PAGES].numpy(),
                                   np.asarray(jpool[k])[:, :PAGES], **KV_TOL)


def test_span_writes_and_attention_equal_reference(setup):
    """``append_tokens_paged``, ``update_layer_cache_multi`` (a masked write
    that would run past max_len is dropped, not clamped) and
    ``spec_verify_attention`` (with and without a window) within 1e-6."""
    cfg, *_ = setup
    rng = np.random.default_rng(7)
    S, Hkv, D, Hq = 5, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    T = NB * BS
    pk, pv = (rng.standard_normal((PAGES + 1, Hkv, BS, D)).astype(np.float32)
              for _ in range(2))
    kc, vc = (rng.standard_normal((3, Hkv, T, D)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((3, Hkv, S, D)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(PAGES)[:3 * NB].reshape(3, NB).astype(np.int32)
    length = np.array([13, T - 2, 30], np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 0, 0, 0], [0, 0, 0, 0, 0]], np.int32)
    j = jkv.append_tokens_paged(*(jnp.asarray(a) for a in
                                  (pk, pv, kn, vn, bt, length, mask)), PAGES)
    t = [torch.from_numpy(a.copy()) for a in (pk, pv)]
    tkv.append_tokens_paged(*t, *(torch.from_numpy(a) for a in
                                  (kn, vn, bt, length, mask)), PAGES)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a[:PAGES].numpy(), np.asarray(b)[:PAGES], **FN_TOL)
    j = jkv.update_layer_cache_multi(*(jnp.asarray(a) for a in
                                       (kc, vc, kn, vn, length, mask)))
    t = [torch.from_numpy(a.copy()) for a in (kc, vc)]
    tkv.update_layer_cache_multi(*t, *(torch.from_numpy(a) for a in
                                       (kn, vn, length, mask)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FN_TOL)
    np.testing.assert_array_equal(t[0][1, :, :T - 2].numpy(), kc[1, :, :T - 2])
    q = rng.standard_normal((3, Hq, S, D)).astype(np.float32)
    for window in (None, 9):
        want = jkv.spec_verify_attention(jnp.asarray(q), jnp.asarray(kc),
                                         jnp.asarray(vc), jnp.asarray(length),
                                         window=window)
        got = tkv.spec_verify_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                        torch.from_numpy(vc),
                                        torch.from_numpy(length), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


# -- the engine against the reference's ----------------------------------------

def make_reqs(mod, vocab, seed=0):
    """Three prompts, then two of them again: the table replays the first
    streams, so drafts land."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, p).astype(np.int32) for p in (8, 5, 11)]
    plan = ((0, 16), (1, 12), (2, 20), (0, 16), (1, 12))
    return [mod.Request(rid=i, prompt=prompts[p].copy(), max_new_tokens=m)
            for i, (p, m) in enumerate(plan)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = sorted(eng.run(), key=lambda r: r.rid)
    return [[int(t) for t in r.out] for r in done]


def _force_layouts(vpe, slots):
    """Fix the ``kv_layout`` decisions, each tried both ways so no trial can
    start: an admission into an empty engine goes paged, every other one
    contiguous."""
    for occ in range(slots + 1):
        bucket = kv_layout_bucket(0, occ, slots)
        first, last = (("contiguous", "paged") if occ == 0
                       else ("paged", "contiguous"))
        vpe.controller.force("kv_layout", bucket, first)
        vpe.controller.force("kv_layout", bucket, last)


def spec_counters(st):
    return (st.spec_calls, st.draft_tokens, st.accepted_tokens,
            dict(st.accept_hist))


@pytest.mark.parametrize("layout", ["paged", "auto"])
@pytest.mark.parametrize("S", [4, 16])
def test_engine_equals_reference(setup, layout, S):
    """The port's engine and the JAX engine serve the same requests at
    ``decode_horizon = spec_draft = S``: equal tokens and equal
    ``spec_calls``, ``draft_tokens``, ``accepted_tokens`` and
    ``accept_hist`` (host logic over equal tokens).  On ``auto`` the
    admission into an empty engine goes paged and the rest contiguous, so
    the mixed verify serves both layouts at once."""
    import repro.core as jcore
    cfg, tcfg, jp, tp = setup
    kw = dict(slots=2, max_len=MAX_LEN, block_size=8, kv_layout=layout,
              decode_horizon=S, spec_draft=S, prefill_chunk=8)
    jvpe = tvpe = None
    if layout == "auto":
        jvpe, tvpe = jcore.VPE(), VPE()
    jeng = jserve.ContinuousBatchingEngine(cfg, jp, vpe=jvpe, decode_impl="grouped",
                                           prefill_kernel="gather", **kw)
    teng = tserve.ContinuousBatchingEngine(tcfg, tp, vpe=tvpe, decode_impl="grouped",
                                           prefill_kernel="gather", device="cpu",
                                           **kw)
    if layout == "auto":
        for vpe in (jvpe, tvpe):
            _force_layouts(vpe, 2)
    want = _run(jeng, make_reqs(jserve, cfg.vocab_size))
    got = _run(teng, make_reqs(tserve, cfg.vocab_size))
    assert got == want
    assert spec_counters(teng.stats) == spec_counters(jeng.stats)
    st = teng.stats
    assert st.spec_calls > 0 and st.accepted_tokens > 0
    if layout == "auto":
        assert 0 < st.paged_admits < len(want)     # both layouts served
    teng.check_kv()
    assert teng.pages.drained


@pytest.mark.parametrize("kw", [dict(kv_layout="contiguous", decode_horizon=4),
                                dict(kv_layout="paged", decode_horizon=1)])
def test_contiguous_and_horizon_one_resolve_to_off(setup, kw):
    """No block table to write candidates through, or no multi-token call
    to speculate on: ``spec_draft`` resolves to ``off`` and the tokens are
    the plain engine's."""
    _, tcfg, _, tp = setup
    base = dict(slots=2, max_len=MAX_LEN, device="cpu", **kw)
    want = _run(tserve.ContinuousBatchingEngine(tcfg, tp, **base),
                make_reqs(tserve, tcfg.vocab_size, seed=1)[:3])
    eng = tserve.ContinuousBatchingEngine(tcfg, tp, spec_draft=4, **base)
    assert _run(eng, make_reqs(tserve, tcfg.vocab_size, seed=1)[:3]) == want
    assert eng.spec_draft == "off" and eng.proposer is None
    assert eng.stats.spec_calls == 0


def test_spec_validation(setup):
    _, tcfg, _, tp = setup
    for kw, what in ((dict(spec_draft=1), "spec_draft"),
                     (dict(spec_draft="sometimes"), "spec_draft"),
                     (dict(spec_choices=(1, 4)), "spec_choices")):
        with pytest.raises(ValueError, match=what):
            tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)


def test_rejected_tail_rollback_leaves_zero_leaks(setup):
    """A cold table misses nearly every draft: each verify call reserves
    pages for its 16-position span (block size 4) and returns the rejected
    tail's through the refcounted pool; the audit is clean and the pool
    drains."""
    _, tcfg, _, tp = setup
    rng = np.random.default_rng(4)
    reqs = [tserve.Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, 8
                                                      ).astype(np.int32),
                           max_new_tokens=20) for i in range(3)]
    eng = tserve.ContinuousBatchingEngine(
        tcfg, tp, slots=2, max_len=MAX_LEN, kv_layout="paged", block_size=4,
        decode_horizon=16, spec_draft=16, device="cpu")
    _run(eng, reqs)
    assert eng.stats.spec_calls > 0
    assert eng.stats.reserved_pages_rolled_back > 0
    eng.check_kv()
    assert all(not s.pages for s in eng.slots)
    assert eng.pages.num_live == 0 and eng.pages.drained


# -- the proposer ---------------------------------------------------------------

def test_proposer_eviction_bound_holds():
    p = NGramProposer(order=3, max_entries=50)
    rng = np.random.default_rng(0)
    for slot in range(4):
        p.observe_prompt(slot, rng.integers(0, 100, 64).tolist())
        assert len(p) <= 50
    for step in range(200):
        p.observe(step % 4, rng.integers(0, 100, 3).tolist())
        assert len(p) <= 50
    assert len(p) == 50


def test_proposer_lru_keeps_recent_contexts():
    p = NGramProposer(order=1, max_entries=2)
    p.observe(0, [1, 2, 3, 4])
    assert len(p) == 2
    p._ctx[0] = [3]
    assert p.draft(0, 1) == [4]
    p._ctx[0] = [1]
    assert p.draft(0, 1) == [p.pad_token]


def test_proposer_replays_and_pads():
    p = NGramProposer(order=3)
    stream = [5, 6, 7, 8, 9, 10]
    p.observe(0, stream)
    p._ctx[1] = stream[:3]
    assert p.draft(1, 3) == stream[3:6]
    assert NGramProposer(order=3, pad_token=0).draft(0, 4) == [0, 0, 0, 0]


# -- the measured axis -------------------------------------------------------------

def test_bucket_shape_and_label():
    b = spec_accept_bucket(3, 2, 4, 0.9)
    assert b == ("spec", 2, 2, 4, 2)
    assert bucket_label(b) == "spec:q[2,4)xocc2/4slotsxacc2"
    assert bucket_label(b + ("slo", 1, 0)) == "spec:q[2,4)xocc2/4slotsxacc2xslo:i1b0"
    assert accept_rate_level(None) == 1
    assert accept_rate_level(0.1) == 0
    assert accept_rate_level(0.5) == 1
    assert accept_rate_level(0.99) == 2


class _Clock:
    """The serve loop's clock in this test: time moves only when the engine
    launches a decode call (one unit a step) or a verify call (two units,
    whatever its span), so every wall the axes see is a fixed function of
    the calls made and the tokens they emitted."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def test_auto_backs_off_on_adversarial_workload(setup, monkeypatch):
    """Unique random prompts, so drafts almost never land: a verify call
    (two units) commits about one token a slot, a plain call one a step
    (one unit).  The ``spec_draft`` axis must trial a span, measure the
    loss and keep ``off`` wherever a trial concluded, while the output
    stays the plain engine's."""
    _, tcfg, _, tp = setup
    clock = _Clock()
    monkeypatch.setattr(tserve, "time", clock)
    vpe = VPE(controller_kwargs=dict(min_samples=2, trial_samples=2))
    eng = tserve.ContinuousBatchingEngine(
        tcfg, tp, slots=2, max_len=MAX_LEN, vpe=vpe, kv_layout="paged",
        decode_horizon=4, spec_draft="auto", spec_choices=(4,),
        decode_impl="grouped", prefill_kernel="gather", device="cpu")
    launch, verify = eng.graphs.launch, eng.graphs.verify

    def timed_launch(impl, horizon):
        clock.t += float(horizon)
        return launch(impl, horizon)

    def timed_verify(tokens):
        clock.t += 2.0
        return verify(tokens)

    monkeypatch.setattr(eng.graphs, "launch", timed_launch)
    monkeypatch.setattr(eng.graphs, "verify", timed_verify)
    rng = np.random.default_rng(5)
    reqs = [tserve.Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, 8
                                                      ).astype(np.int32),
                           max_new_tokens=10) for i in range(30)]
    for lo in range(0, len(reqs), 6):
        for r in reqs[lo:lo + 6]:
            eng.submit(r)
        eng.run()
    specs = [d for (op, _), d in vpe.controller._decisions.items()
             if op == "spec_draft"]
    trialed = [d for d in specs if any(ev[0] == "trial" for ev in d.history)]
    concluded = [d for d in trialed if d.trialing is None
                 and any(ev[0] in ("revert", "switch") for ev in d.history)]
    assert trialed and concluded
    assert all(d.selected == "off" for d in concluded), \
        [(d.selected, d.history) for d in concluded]
    st = eng.stats
    assert st.spec_calls > 0 and st.accepted_tokens / st.draft_tokens < 0.3
    plain = tserve.ContinuousBatchingEngine(
        tcfg, tp, slots=2, max_len=MAX_LEN, kv_layout="paged", device="cpu")
    want = _run(plain, [tserve.Request(rid=r.rid, prompt=r.prompt,
                                       max_new_tokens=r.max_new_tokens)
                        for r in reqs[:6]])
    assert [r.out for r in sorted(eng.completed, key=lambda r: r.rid)[:6]] == want
    eng.check_kv()
