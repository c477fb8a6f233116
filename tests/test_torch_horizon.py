"""Fused decode horizons of the port against ``repro`` (after
tests/test_decode_horizon.py): ``decode_steps_paged`` on the same pool,
cache and inputs; the engine at H in {4, 16} token-exact with H = 1 and
with the JAX engine at the same H; budget and EOS stops mid-horizon;
reserved-page rollback; the write range installed before a fused call;
the measured ``decode_horizon`` axis; validation; the bucket functions;
and the fixed addresses of the engine's decode buffers, the CPU stand-in
for the CUDA graphs that replay over them on the card.

Reduced qwen3-8b in f32, weights carried across with ``params_from_jax``.
On the CPU the port's ``cuda`` variants run their kernels' plain versions.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.core import decode_horizon_bucket as j_hzn_bucket  # noqa: E402
from repro.core import queue_depth_bucket as j_queue_bucket  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import VPE, bucket_label  # noqa: E402
from repro_torch.core import decode_horizon_bucket, queue_depth_bucket  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

torch.set_num_threads(1)
MAX_LEN = 64
# the pool after a fused call: the same appends in f32, computed by two
# libraries (tests/test_torch_model.py's limit for one step)
KV_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    cfg = ARCHS["qwen3-8b"].reduced()
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_config("qwen3-8b").reduced(), jp, tp


def make_reqs(mod, vocab, seed=0, plens=(8, 5, 11), maxnew=(20, 7, 13), eos=None):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, p).astype(np.int32),
                        max_new_tokens=m, eos_id=None if eos is None else eos[i])
            for i, (p, m) in enumerate(zip(plens, maxnew))]


def port_engine(setup, **kw):
    _, tcfg, _, tp = setup
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    return tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)


def run_port(setup, reqs, **kw):
    eng = port_engine(setup, **kw)
    for r in reqs:
        eng.submit(r)
    done = sorted(eng.run(), key=lambda r: r.rid)
    eng.check_kv()
    assert eng.pages.drained and eng.num_active == 0
    return [[int(t) for t in r.out] for r in done], eng


# -- the model function --------------------------------------------------------

BS, NB, PAGES = 8, 6, 20


@pytest.mark.parametrize("impls", [("grouped", "grouped"), ("pallas", "cuda")])
def test_decode_steps_paged_equals_reference(setup, impls):
    """Three slots over one pool: slot 0 stops on EOS mid-horizon, slot 1
    on its budget of 2, slot 2 is not live.  Valid tokens, the valid mask,
    the final tokens and the lengths equal the reference's; the pool
    within KV_TOL."""
    cfg, tcfg, jp, tp = setup
    H = 6
    rng = np.random.default_rng(3)
    shape = (cfg.num_layers, PAGES + 1, cfg.num_kv_heads, BS, cfg.head_dim)
    pool = {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}
    bt = rng.permutation(PAGES)[:3 * NB].reshape(3, NB).astype(np.int32)
    length = np.array([13, 29, 5], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    live = np.array([1, 1, 0], np.int32)
    budget = np.array([H, 2, 0], np.int32)

    def jax_call(eos):
        return jmodel.decode_steps_paged(
            cfg, jp, {k: jnp.asarray(v) for k, v in pool.items()},
            {"bt": jnp.asarray(bt), "length": jnp.asarray(length)},
            jnp.asarray(tokens), jnp.asarray(live), jnp.asarray(eos),
            jnp.asarray(budget), H, decode_impl=impls[0])

    # slot 0's EOS: its first token at step >= 2 not seen before it
    free_run = np.asarray(jax_call(np.full(3, -1, np.int32))[2])[0]
    j = next(j for j in range(2, H) if free_run[j] not in free_run[:j])
    eos = np.array([free_run[j], -1, -1], np.int32)
    jpool, jcache, jtoks, jvalid, jfinal = jax_call(eos)

    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    tcache = {"bt": torch.from_numpy(bt.copy()),
              "length": torch.from_numpy(length.copy())}
    length_buf = tcache["length"]
    _, tcache_out, ttoks, tvalid, tfinal = tmodel.decode_steps_paged(
        tcfg, tp, tpool, tcache, torch.from_numpy(tokens), torch.from_numpy(live),
        torch.from_numpy(eos), torch.from_numpy(budget), H, decode_impl=impls[1])

    jvalid = np.asarray(jvalid)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    assert tvalid.numpy().sum(1).tolist() == [j + 1, 2, 0]
    np.testing.assert_array_equal(ttoks.numpy() * jvalid, np.asarray(jtoks) * jvalid)
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    assert tcache_out["length"] is length_buf           # written in place
    np.testing.assert_array_equal(length_buf.numpy(), np.asarray(jcache["length"]))
    np.testing.assert_array_equal(length_buf.numpy(), length + [j + 1, 2, 0])
    for k in "kv":   # the trash row is never compared
        np.testing.assert_allclose(tpool[k][:, :PAGES].numpy(),
                                   np.asarray(jpool[k])[:, :PAGES], **KV_TOL)


def test_single_step_advance_mask(setup):
    """``advance`` moves each length by its own amount, in place."""
    _, tcfg, _, tp = setup
    pool = tmodel.init_page_pool(tcfg, PAGES, BS, torch.device("cpu"))
    cache = tmodel.init_paged_cache(tcfg, 2, NB * BS, BS, PAGES, torch.device("cpu"))
    cache["length"][:] = torch.tensor([3, 9], dtype=torch.int32)
    buf = cache["length"]
    tokens = torch.tensor([[1], [2]], dtype=torch.int32)
    live = torch.tensor([1, 1], dtype=torch.int32)
    tmodel.decode_step_paged(tcfg, tp, pool, cache, tokens, live,
                             advance=torch.tensor([1, 0], dtype=torch.int32))
    assert cache["length"] is buf and buf.tolist() == [4, 9]
    tmodel.decode_step_paged(tcfg, tp, pool, cache, tokens, live)
    assert buf.tolist() == [5, 10]


# -- the engine ----------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_tokens(setup):
    """The JAX engine's tokens (paged, grouped/gather) at H = 1, 4, 16."""
    cfg, _, jp, _ = setup
    out = {}
    for H in (1, 4, 16):
        eng = jserve.ContinuousBatchingEngine(
            cfg, jp, slots=2, max_len=MAX_LEN, kv_layout="paged",
            decode_horizon=H, decode_impl="grouped", prefill_kernel="gather")
        for r in make_reqs(jserve, cfg.vocab_size):
            eng.submit(r)
        out[H] = [[int(t) for t in r.out]
                  for r in sorted(eng.run(), key=lambda r: r.rid)]
    return out


@pytest.mark.parametrize("impls", [("grouped", "gather"), ("cuda", "cuda")])
@pytest.mark.parametrize("horizon", [4, 16])
def test_fused_matches_single_step_and_reference(setup, reference_tokens,
                                                 horizon, impls):
    """Staggered budgets force stops mid-horizon and admissions between
    fused calls; the tokens equal H = 1's and the JAX engine's at the
    same H."""
    _, tcfg, _, _ = setup
    kw = dict(decode_impl=impls[0], prefill_kernel=impls[1])
    single, eng1 = run_port(setup, make_reqs(tserve, tcfg.vocab_size),
                            decode_horizon=1, **kw)
    fused, eng = run_port(setup, make_reqs(tserve, tcfg.vocab_size),
                          decode_horizon=horizon, **kw)
    assert single == reference_tokens[1]
    assert fused == single == reference_tokens[horizon]
    assert eng.stats.horizon_calls > 0 and eng.stats.horizon_tokens > 0
    assert eng1.stats.horizon_calls == 0
    assert set(eng1.stats.horizon_hist) == {1}
    assert sum(H * n for H, n in eng.stats.horizon_hist.items()) \
        == eng.stats.decode_steps
    assert eng.stats.tainted_steps == 0          # nothing is captured on the CPU
    assert f"{eng.stats.horizon_calls} fused horizons" in eng.stats.summary()


def test_budget_stop_is_exact(setup):
    _, tcfg, _, _ = setup
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 8).astype(np.int32)
    ref, _ = run_port(setup, [tserve.Request(rid=0, prompt=prompt, max_new_tokens=5)],
                      decode_horizon=1)
    out, eng = run_port(setup, [tserve.Request(rid=0, prompt=prompt, max_new_tokens=5)],
                        decode_horizon=16)
    assert out == ref and len(out[0]) == 5
    # remaining 4 clamps 16 onto the declared set {1, 16}: single steps
    assert eng.stats.horizon_hist == {1: 4}


def _eos_setup(setup):
    """A single-step run and an EOS token whose FIRST occurrence is at
    least four tokens in, so the stop fires inside a horizon."""
    _, tcfg, _, _ = setup
    prompt = np.random.default_rng(2).integers(0, tcfg.vocab_size, 8).astype(np.int32)
    (ref,), _ = run_port(setup, [tserve.Request(rid=0, prompt=prompt, max_new_tokens=24)],
                         block_size=4, decode_horizon=1)
    eos = next(t for i, t in enumerate(ref) if i >= 4 and t not in ref[:i])
    return prompt, ref, eos


@pytest.mark.parametrize("impl", ["grouped", "cuda"])
def test_eos_mid_horizon_emits_no_trailing_tokens(setup, impl):
    prompt, ref, eos = _eos_setup(setup)
    k = ref.index(eos)
    (out,), eng = run_port(
        setup, [tserve.Request(rid=0, prompt=prompt, max_new_tokens=24, eos_id=eos)],
        block_size=4, decode_horizon=16, decode_impl=impl)
    assert out == ref[:k + 1]
    assert eng.completed[0].status == "done"


def test_reserved_page_rollback_leaves_zero_leaks(setup):
    """EOS freezing a slot mid-horizon strands the pages reserved for the
    rest of it (block 4 << horizon 16); they go back to the pool."""
    prompt, ref, eos = _eos_setup(setup)
    (out,), eng = run_port(
        setup, [tserve.Request(rid=0, prompt=prompt, max_new_tokens=24, eos_id=eos)],
        block_size=4, decode_horizon=16)
    assert eng.stats.reserved_pages_rolled_back > 0
    assert all(not s.pages for s in eng.slots)
    assert eng.pages.num_live == 0
    assert sorted(eng.pages.free) == list(range(eng.pages.num_pages))


def test_horizon_reservation_installs_whole_write_range(setup):
    """After a fused call the device block-table row mirrors the slot's
    host pages, which cover everything written; before the next fused
    call the row covers its whole write range."""
    _, tcfg, _, _ = setup
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, 8).astype(np.int32)
    eng = port_engine(setup, slots=1, block_size=4, decode_horizon=8)
    eng.submit(tserve.Request(rid=0, prompt=prompt, max_new_tokens=20))
    eng.step()                           # admit, prefill, first fused call
    slot = eng.slots[0]
    assert len(slot.pages) * 4 >= slot.pos
    assert eng.cache["bt"][0, :len(slot.pages)].tolist() == slot.pages
    remaining = {0: slot.req.max_new_tokens - len(slot.req.out)}
    eng._grow_block_tables(span=8, remaining=remaining)
    upto = slot.pos + min(8, remaining[0])
    assert len(slot.pages) == -(-upto // 4)
    assert eng.cache["bt"][0, :len(slot.pages)].tolist() == slot.pages
    eng.run()
    eng.check_kv()
    assert eng.pages.drained


def test_single_step_growth_unchanged(setup):
    """H = 1 allocates a page exactly when the next token starts a block."""
    _, tcfg, _, _ = setup
    prompt = np.random.default_rng(4).integers(0, tcfg.vocab_size, 8).astype(np.int32)
    eng = port_engine(setup, slots=1, block_size=4, decode_horizon=1)
    eng.submit(tserve.Request(rid=0, prompt=prompt, max_new_tokens=10))
    eng.step()                           # prefill: 8 positions, 2 pages
    seen = []
    while eng.slots[0].req is not None:
        pos = eng.slots[0].pos
        eng.step()
        if eng.slots[0].req is not None:
            seen.append((pos, len(eng.slots[0].pages)))
    assert all(n == pos // 4 + 1 for pos, n in seen), seen
    assert eng.slots[0].pages == [] and eng.pages.drained
    assert eng.stats.reserved_pages_rolled_back == 0


def test_auto_axis_trials_and_stays_exact(setup):
    _, tcfg, _, _ = setup
    kw = dict(plens=(8, 8, 8, 8), maxnew=(30, 30, 30, 30))
    refs, _ = run_port(setup, make_reqs(tserve, tcfg.vocab_size, 5, **kw),
                       decode_horizon=1)
    vpe = VPE(controller_kwargs=dict(min_samples=2, trial_samples=2, hysteresis=0.0))
    outs, eng = run_port(setup, make_reqs(tserve, tcfg.vocab_size, 5, **kw),
                         decode_horizon="auto", horizon_choices=(4, 16), vpe=vpe)
    assert outs == refs
    assert set(vpe.registry.op("decode_horizon").variants) == {"1", "4", "16"}
    hzn = [d for (op, _), d in vpe.controller._decisions.items()
           if op == "decode_horizon"]
    assert hzn, "decode_horizon axis never exercised"
    assert len({v for d in hzn for v in d.tried}) >= 2
    assert any("trial" in [e for e, _, _ in d.history] for d in hzn)


def test_admission_latency_bounded_under_pressure(setup):
    """Pressure buckets forced to 1 and the empty-queue bucket to 16: a
    queued request waits at most one single step after a slot frees, and
    the drained tail runs 16-token fused calls."""
    _, tcfg, _, _ = setup
    rng = np.random.default_rng(6)
    vpe = VPE(controller_kwargs=dict(min_samples=10 ** 6))
    eng = port_engine(setup, slots=1, decode_horizon="auto",
                      horizon_choices=(4, 16), vpe=vpe)
    for q in range(8):
        vpe.controller.force("decode_horizon", decode_horizon_bucket(q, 1, 1),
                             "1" if q > 0 else "16")
    reqs = [tserve.Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, 8)
                           .astype(np.int32), max_new_tokens=6) for i in range(4)]
    reqs.append(tserve.Request(rid=4, prompt=rng.integers(0, tcfg.vocab_size, 8)
                               .astype(np.int32), max_new_tokens=32))
    for r in reqs:
        eng.submit(r)
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert len(done) == 5
    for r in done[:4]:
        assert r.done_step - r.admit_step == len(r.out) - 1
    assert eng.stats.horizon_hist.get(16, 0) >= 1
    assert set(eng.stats.horizon_hist) == {1, 16}
    assert eng.stats.horizon_tokens <= done[4].max_new_tokens
    eng.check_kv()


@pytest.mark.parametrize("kw", [dict(decode_horizon="sometimes"),
                                dict(decode_horizon=0),
                                dict(horizon_choices=(1, 4))])
def test_horizon_validation(setup, kw):
    with pytest.raises(ValueError):
        port_engine(setup, **kw)


def test_bucket_functions_equal_reference():
    for q in range(0, 70):
        assert queue_depth_bucket(q) == j_queue_bucket(q)
        for total in (1, 2, 3, 4, 8):
            for active in range(0, total + 1):
                for levels in (2, 4):
                    assert decode_horizon_bucket(q, active, total, levels=levels) \
                        == j_hzn_bucket(q, active, total, levels=levels)
    assert queue_depth_bucket(-3) == j_queue_bucket(-3) == 0
    assert bucket_label(decode_horizon_bucket(3, 2, 4)) == "horizon:q[2,4)xocc2/4slots"


def test_decode_buffers_keep_their_addresses(setup):
    """The decode inputs, block table, lengths and pool keep their data
    pointers across admissions, prefill completions, retires and steps —
    the addresses a captured graph replays over."""
    _, tcfg, _, _ = setup
    eng = port_engine(setup, prefill_chunk=4, decode_horizon=4)

    def pointers():
        g = eng.graphs
        return [t.data_ptr() for t in (eng._inputs, g.tok, g.live, g.eos, g.budget,
                                       eng.cache["bt"], eng.cache["length"],
                                       eng.page_pool["k"], eng.page_pool["v"])]

    before = pointers()
    graphs = eng.graphs
    for r in make_reqs(tserve, tcfg.vocab_size, eos=(None, 7, None)):
        eng.submit(r)
    events = set()
    while eng.queue or eng.num_active:
        admits, done = len(eng.stats.queue_wait_s), len(eng.completed)
        prefilled = eng.stats.prefill_tokens
        eng.step()
        events.update(e for e, moved in (
            ("admit", len(eng.stats.queue_wait_s) > admits),
            ("prefill done", eng.stats.prefill_tokens > prefilled),
            ("retire", len(eng.completed) > done)) if moved)
        assert pointers() == before
        assert eng.graphs is graphs and graphs.pool is eng.page_pool \
            and graphs.cache is eng.cache
    assert events == {"admit", "prefill done", "retire"}
    assert eng.stats.horizon_calls > 0
    assert graphs.captures == 0 and graphs.pool_bytes() == 0   # CPU: eager


@pytest.mark.parametrize("horizon", ["16", "auto"])
def test_launcher_decode_horizon(capsys, horizon):
    from repro_torch.launch import serve as tlaunch
    tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--continuous", "--device",
                  "cpu", "--requests", "3", "--new-tokens", "20", "--max-len",
                  "48", "--decode-horizon", horizon])
    out = capsys.readouterr().out
    assert "completed 3 requests" in out
    if horizon == "16":
        assert "fused horizons" in out
    else:
        assert "decode_horizon" in out          # the axis's decision rows
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--continuous", "--device",
                      "cpu", "--decode-horizon", "often"])
    assert "--decode-horizon" in capsys.readouterr().err
