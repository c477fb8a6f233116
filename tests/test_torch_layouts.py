"""The contiguous and ``auto`` KV layouts of the port against ``repro``.

The slot cache's writes and the prefix pools' page transfers bit-equal to
the JAX functions on the same numpy inputs; the contiguous, suffix and
lockstep prefills and the contiguous, mixed and fused decode steps within
the logit limit of tests/test_torch_model.py on the same weights (reduced
qwen3-8b; reduced h2o-danube-3-4b for the lockstep ring cache); the wave
path (``ServeLoop.generate``, ``WaveScheduler``) giving the reference's
tokens; the engine's layouts agreeing token for token (contiguous ≡ paged,
contiguous H = 4 ≡ H = 1 ≡ the JAX engine at H = 4); and the launcher's
contiguous, ``auto`` and wave paths on the CPU.  f32 weights throughout;
the slot cache stores bf16, as the reference's does.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
# logits of one step or prefill: tests/test_torch_model.py's limit (the same
# f32 arithmetic in two libraries)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# K/V stored in the bf16 slot cache: values the two libraries compute
# within 1e-5 may round to neighbouring bf16 values, one step apart (a
# step is 2^-8 to 2^-7 of the value, by where it sits in its binade)
SLOT_TOL = dict(rtol=2 ** -7, atol=1e-5)
# the page pool after a step, f32: tests/test_torch_model.py's limit
KV_TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(arch):
    cfg = ARCHS[arch].reduced()
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_config(arch).reduced(), jp, tp


@pytest.fixture(scope="module")
def setup():
    return _setup("qwen3-8b")


@pytest.fixture(scope="module")
def danube():
    return _setup("h2o-danube-3-4b")


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _np(x):
    """A torch or JAX array as numpy f32 (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- the slot cache and the page transfers: bit-equal ---------------------------

def test_insert_slot_kv_bit_equal():
    """insert_slot_kv, then insert_slot_kv_at past a prefix and at a start
    that JAX clamps: the bf16 cache and lengths equal JAX's bit for bit,
    written in place."""
    rng = np.random.default_rng(0)
    L, B, H, T, D = 2, 3, 2, 32, 4
    jc = jkv.init_kv_cache(L, B, H, T, D, per_slot=True)
    tc = tkv.init_kv_cache(L, B, H, T, D, per_slot=True, device=CPU)
    ptrs = [t.data_ptr() for t in tc.values()]
    for slot, start, S, n in ((1, 0, 16, 11), (1, 16, 8, 20), (2, 0, 8, 5),
                              (0, 28, 8, 30)):
        k = rng.standard_normal((L, 1, H, S, D)).astype(np.float32)
        v = rng.standard_normal((L, 1, H, S, D)).astype(np.float32)
        if start:
            jc = jkv.insert_slot_kv_at(jc, k, v, jnp.int32(slot),
                                       jnp.int32(start), jnp.int32(n))
            tkv.insert_slot_kv_at(tc, _t(k), _t(v), slot, start, n)
        else:
            jc = jkv.insert_slot_kv(jc, k, v, jnp.int32(slot), jnp.int32(n))
            tkv.insert_slot_kv(tc, _t(k), _t(v), slot, n)
    for key in "kv":
        np.testing.assert_array_equal(_np(tc[key]), _np(jc[key]))
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    assert [t.data_ptr() for t in tc.values()] == ptrs


def test_block_pool_bit_equal():
    """write_block (a start JAX clamps included), then gather_blocks of the
    contiguous layout's prefix pool."""
    rng = np.random.default_rng(1)
    L, H, bs, D = 2, 2, 8, 4
    jpool = jkv.init_block_pool(4, L, H, bs, D, dtype=jnp.float32)
    tpool = tkv.init_block_pool(4, L, H, bs, D, dtype=torch.float32, device=CPU)
    k = rng.standard_normal((L, 1, H, 24, D)).astype(np.float32)
    v = rng.standard_normal((L, 1, H, 24, D)).astype(np.float32)
    for bid, start in ((2, 8), (0, 16), (3, 20)):
        jpool = jkv.write_block(jpool, k, v, bid, start, bs)
        tkv.write_block(tpool, _t(k), _t(v), bid, start, bs)
    ids = np.array([2, 0, 3, 2], np.int32)
    jg = jkv.gather_blocks(jpool, jnp.asarray(ids))
    tg = tkv.gather_blocks(tpool, _t(ids))
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(_np(a), _np(b))
    for key in "kv":
        np.testing.assert_array_equal(_np(tpool[key]), _np(jpool[key]))


def test_page_transfers_bit_equal():
    """write_pages — a block written from mid-block (a copy-on-write
    clone), full blocks and a final partial block — then gather_pages."""
    rng = np.random.default_rng(2)
    L, H, bs, D, N = 2, 2, 8, 4, 6
    shape = (L, N + 1, H, bs, D)
    init = {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}
    jpool = {k: jnp.asarray(v) for k, v in init.items()}
    tpool = {k: _t(v) for k, v in init.items()}
    k = rng.standard_normal((L, 1, H, 32, D)).astype(np.float32)
    v = rng.standard_normal((L, 1, H, 32, D)).astype(np.float32)
    ids, starts = np.array([4, 1, 5], np.int32), np.array([8, 16, 24], np.int32)
    jpool = jkv.write_pages(jpool, k, v, jnp.asarray(ids), jnp.asarray(starts),
                            jnp.int32(11), jnp.int32(19))
    tkv.write_pages(tpool, _t(k), _t(v), _t(ids), _t(starts), 11, 19)
    for key in "kv":
        np.testing.assert_array_equal(tpool[key].numpy(), np.asarray(jpool[key]))
    gids = np.array([5, 4, 4], np.int32)
    for a, b in zip(tkv.gather_pages(tpool, _t(gids)),
                    jkv.gather_pages(jpool, jnp.asarray(gids))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", ["per_slot", "scalar", "ring"])
def test_update_layer_cache_bit_equal(case):
    """One layer's write at per-slot lengths (one past the end, which JAX
    clamps), at a scalar length, and into a ring."""
    rng = np.random.default_rng(3)
    B, H, T, D = 3, 2, 16, 4
    kc = rng.standard_normal((B, H, T, D)).astype(np.float32)
    vc = rng.standard_normal((B, H, T, D)).astype(np.float32)
    S = 1 if case != "scalar" else 5
    kn = rng.standard_normal((B, H, S, D)).astype(np.float32)
    vn = rng.standard_normal((B, H, S, D)).astype(np.float32)
    length = (np.array([3, 16, 0], np.int32) if case == "per_slot"
              else np.array(13 if case == "scalar" else 37, np.int32))
    rw = T if case == "ring" else None
    jk, jv = jkv.update_layer_cache(jnp.asarray(kc), jnp.asarray(vc), kn, vn,
                                    jnp.asarray(length), ring_window=rw)
    tk, tv = _t(kc), _t(vc)
    tkv.update_layer_cache(tk, tv, _t(kn), _t(vn), _t(length), ring_window=rw)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- the model functions: logits within the limit ---------------------------------

def test_prefill_slot_and_suffix_equal_reference(setup):
    """prefill_slot_kv of a padded prompt, and prefill_suffix_kv of its
    suffix against its first 16 positions' K/V gathered as pages (padded to
    24 columns, masked): K/V and logits."""
    cfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(4)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :27] = rng.integers(0, cfg.vocab_size, 27)
    jk, jv, jl = jmodel.prefill_slot_kv(cfg, jp, jnp.asarray(toks), jnp.int32(27))
    tk, tv, tl = tmodel.prefill_slot_kv(tcfg, tp, _t(toks), 27)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **KV_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **KV_TOL)
    P, sl = 16, 11
    pk = np.concatenate([np.asarray(jk)[:, :, :, :P], np.asarray(jk)[:, :, :, :8]], 3)
    pv = np.concatenate([np.asarray(jv)[:, :, :, :P], np.asarray(jv)[:, :, :, :8]], 3)
    sfx = np.zeros((1, 16), np.int32)
    sfx[0, :sl] = toks[0, P:P + sl]
    jk2, jv2, jl2 = jmodel.prefill_suffix_kv(cfg, jp, jnp.asarray(sfx), pk, pv,
                                             jnp.int32(P), jnp.int32(sl))
    tk2, tv2, tl2 = tmodel.prefill_suffix_kv(tcfg, tp, _t(sfx), _t(pk), _t(pv),
                                             P, sl)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **LOGIT_TOL)
    np.testing.assert_allclose(tk2.numpy(), np.asarray(jk2), **KV_TOL)
    # the warm suffix's logits are the whole prompt's
    np.testing.assert_allclose(tl2.numpy(), tl.numpy(), **LOGIT_TOL)


def _slot_state(cfg, seed, B=3, T=48):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, B, cfg.num_kv_heads, T, cfg.head_dim)
    # bf16 values, held as f32
    kv = {k: np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                        .astype(jnp.float32)) for k in "kv"}
    return kv, np.array([5, 20, 11], np.int32)[:B], rng


def _jax_cache(kv, length, extra=None):
    c = {"k": jnp.asarray(kv["k"], jnp.bfloat16),
         "v": jnp.asarray(kv["v"], jnp.bfloat16), "length": jnp.asarray(length)}
    return {**c, **(extra or {})}


def _port_cache(kv, length, extra=None):
    c = {"k": _t(kv["k"]).to(torch.bfloat16), "v": _t(kv["v"]).to(torch.bfloat16),
         "length": _t(length)}
    return {**c, **(extra or {})}


@pytest.mark.parametrize("impls", [("grouped", "grouped"), ("flat", "flat"),
                                   ("pallas", "cuda")])
def test_decode_step_contiguous_equals_reference(setup, impls):
    """One per-slot decode step with an advance mask: logits, the cache
    (bf16) and the lengths, moved in place."""
    cfg, tcfg, jp, tp = setup
    kv, length, rng = _slot_state(cfg, 5)
    tokens = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    adv = np.array([1, 0, 1], np.int32)
    jc, jl = jtf.decode_step(cfg, jp, _jax_cache(kv, length), jnp.asarray(tokens),
                             decode_impl=impls[0], advance=jnp.asarray(adv))
    tc = _port_cache(kv, length)
    buf = tc["length"]
    _, tl = tmodel.decode_step(tcfg, tp, tc, _t(tokens), decode_impl=impls[1],
                               advance=_t(adv))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for key in "kv":
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **SLOT_TOL)
    assert tc["length"] is buf and buf.tolist() == np.asarray(jc["length"]).tolist()


def _mixed_state(cfg, seed):
    """A slot cache with a block table over a random f32 pool: slot 0
    paged and live, slot 1 contiguous and live, slot 2 paged, not live."""
    kv, length, rng = _slot_state(cfg, seed)
    bs, nb, N = 8, 6, 20
    pshape = (cfg.num_layers, N + 1, cfg.num_kv_heads, bs, cfg.head_dim)
    pool = {k: rng.standard_normal(pshape).astype(np.float32) for k in "kv"}
    bt = rng.permutation(N)[:3 * nb].reshape(3, nb).astype(np.int32)
    inputs = dict(tokens=rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32),
                  use_paged=np.array([1, 0, 1], np.int32),
                  live=np.array([1, 1, 0], np.int32),
                  eos=np.array([-1, -1, -1], np.int32),
                  budget=np.array([16, 3, 0], np.int32))
    return kv, length, pool, bt, inputs


@pytest.mark.parametrize("impls", [("grouped", "grouped"), ("pallas", "cuda")])
@pytest.mark.parametrize("horizon", [1, 4])
def test_mixed_decode_equals_reference(setup, impls, horizon):
    """decode_step_mixed (horizon 1) and decode_steps_mixed (4): logits or
    the token block, valid mask and final tokens; the slot cache, the
    pool's pages and the lengths after it."""
    cfg, tcfg, jp, tp = setup
    kv, length, pool, bt, x = _mixed_state(cfg, 6 + horizon)
    jc = _jax_cache(kv, length, {"bt": jnp.asarray(bt)})
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tc = _port_cache(kv, length, {"bt": _t(bt)})
    tpool = {k: _t(v) for k, v in pool.items()}
    if horizon == 1:
        jc, jpool, jl = jmodel.decode_step_mixed(
            cfg, jp, jc, jpool, jnp.asarray(x["tokens"]), jnp.asarray(x["use_paged"]),
            jnp.asarray(x["live"]), decode_impl=impls[0])
        _, _, tl = tmodel.decode_step_mixed(
            tcfg, tp, tc, tpool, _t(x["tokens"]), _t(x["use_paged"]), _t(x["live"]),
            decode_impl=impls[1])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    else:
        args = [x[k] for k in ("use_paged", "live", "eos", "budget")]
        jc, jpool, jtoks, jvalid, jfinal = jmodel.decode_steps_mixed(
            cfg, jp, jc, jpool, jnp.asarray(x["tokens"]),
            *map(jnp.asarray, args), horizon, decode_impl=impls[0])
        _, _, ttoks, tvalid, tfinal = tmodel.decode_steps_mixed(
            tcfg, tp, tc, tpool, _t(x["tokens"]), *map(_t, args), horizon,
            decode_impl=impls[1])
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal((ttoks * tvalid).numpy(),
                                      np.asarray(jtoks * jvalid))
        np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    for key in "kv":
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **SLOT_TOL)
        np.testing.assert_allclose(tpool[key][:, :-1].numpy(),
                                   np.asarray(jpool[key])[:, :-1], **KV_TOL)


def test_decode_steps_slots_equals_reference(setup):
    """A fused contiguous horizon of 8 with one slot's budget running out
    and one slot not live: tokens, valid mask, final tokens, lengths."""
    cfg, tcfg, jp, tp = setup
    kv, length, rng = _slot_state(cfg, 9)
    tokens = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    args = [np.array(a, np.int32) for a in ([1, 1, 0], [-1, -1, -1], [8, 3, 0])]
    jc, jtoks, jvalid, jfinal = jmodel.decode_steps_slots(
        cfg, jp, _jax_cache(kv, length), jnp.asarray(tokens),
        *map(jnp.asarray, args), 8, decode_impl="grouped")
    tc = _port_cache(kv, length)
    _, ttoks, tvalid, tfinal = tmodel.decode_steps_slots(
        tcfg, tp, tc, _t(tokens), *map(_t, args), 8, decode_impl="grouped")
    assert tvalid.sum(1).tolist() == [8, 3, 0]
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal((ttoks * tvalid).numpy(), np.asarray(jtoks * jvalid))
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))


def test_lockstep_ring_prefill_and_decode_equal_reference(danube):
    """Reduced h2o-danube-3-4b (window 16): a 20-token lockstep prefill into
    a 16-position ring, then three decode steps wrapping around it, each
    from the reference's cache (so a bf16 rounding of one step does not
    carry into the next step's logits)."""
    cfg, tcfg, jp, tp = danube
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jc = jmodel.init_cache(cfg, 2, 48)
    tc = tmodel.init_cache(tcfg, 2, 48, CPU)
    assert tc["k"].shape[3] == 16 and tc["length"].ndim == 0
    jc, jl = jmodel.prefill(cfg, jp, {"tokens": jnp.asarray(toks)}, jc)
    tc, tl = tmodel.prefill(tcfg, tp, {"tokens": _t(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for _ in range(3):
        for key in "kv":
            tc[key].copy_(torch.from_numpy(np.array(_np(jc[key]))))
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jc, jl = jmodel.decode_step(cfg, jp, jc, jnp.asarray(tok))
        tc, tl = tmodel.decode_step(tcfg, tp, tc, _t(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        for key in "kv":
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **SLOT_TOL)
    assert int(tc["length"]) == int(jc["length"]) == 23


# -- the wave path ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-8b", "h2o-danube-3-4b"])
def test_wave_scheduler_equals_reference(setup, danube, arch):
    """WaveScheduler over ServeLoop: 5 requests of 4–22 tokens in waves of
    2 (left-padded, decoded for the wave's longest budget): every request's
    tokens are the reference's (the danube waves run the ring cache)."""
    cfg, tcfg, jp, tp = setup if arch == "qwen3-8b" else danube
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (4, 22, 9, 17, 6)]
    out = {}
    for mod, serve in ((jserve, jserve.ServeLoop(cfg, jp, max_len=48, batch=2)),
                       (tserve, tserve.ServeLoop(tcfg, tp, max_len=48, batch=2,
                                                 device="cpu"))):
        sched = mod.WaveScheduler(serve)
        for i, p in enumerate(prompts):
            sched.submit(mod.Request(rid=i, prompt=p, max_new_tokens=3 + i % 3))
        out[mod] = {r.rid: [int(t) for t in r.out] for r in sched.run()}
    assert out[tserve] == out[jserve]
    assert sorted(len(v) for v in out[tserve].values()) == [3, 3, 4, 4, 5]


# -- the engine's layouts -----------------------------------------------------------

def _requests(mod, vocab, seed=12, n=5, new=7):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(5, 30))
                                                   ).astype(np.int32),
                        max_new_tokens=new)
            for i in range(n)]


def _serve(eng, mod, vocab, **kw):
    for r in _requests(mod, vocab, **kw):
        eng.submit(r)
    done = eng.run()
    eng.check_kv()
    return {r.rid: [int(t) for t in r.out] for r in done}


@pytest.fixture(scope="module")
def reference_h4(setup):
    """The JAX engine's tokens on the contiguous layout at H = 4."""
    cfg, _, jp, _ = setup
    eng = jserve.ContinuousBatchingEngine(cfg, jp, slots=2, max_len=64,
                                          kv_layout="contiguous", decode_horizon=4,
                                          decode_impl="grouped")
    return _serve(eng, jserve, cfg.vocab_size)


@pytest.mark.parametrize("kw", [
    dict(kv_layout="contiguous", decode_horizon=1, decode_impl="grouped"),
    dict(kv_layout="contiguous", decode_horizon=4, decode_impl="flat"),
    dict(kv_layout="contiguous", decode_horizon=4, decode_impl="cuda"),
    dict(kv_layout="paged", decode_horizon=4, decode_impl="cuda",
         prefill_kernel="cuda", prefill_chunk=8, block_size=8),
    dict(kv_layout="auto", decode_horizon=4, decode_impl="cuda", block_size=8)],
    ids=["contiguous-H1", "contiguous-H4-flat", "contiguous-H4-cuda",
         "paged-H4", "auto-H4"])
def test_engine_layouts_equal_reference(setup, reference_h4, kw):
    """Every layout, horizon and decode variant of the port's engine gives
    the JAX engine's contiguous tokens at H = 4, token for token (the
    contiguous ``cuda`` variant is the grouped rung); the contiguous
    engine's horizons count as fused, and the pool-less engine has no
    pages to audit."""
    _, tcfg, _, tp = setup
    eng = tserve.ContinuousBatchingEngine(tcfg, tp, slots=2, max_len=64,
                                          device="cpu", **kw)
    assert _serve(eng, tserve, tcfg.vocab_size) == reference_h4
    if kw["kv_layout"] == "contiguous":
        assert eng.pages is None and eng.page_pool is None
        assert (eng.stats.horizon_calls > 0) == (kw["decode_horizon"] > 1)
        assert eng.stats.kv_place_s and not eng.stats.paged_admits
    else:
        assert eng.pages.drained
    if kw["kv_layout"] == "auto":     # no VPE: every admission contiguous
        assert all(s.layout == "contiguous" for s in eng.slots)


def test_contiguous_vpe_offers_no_kernel_variant(setup):
    """A contiguous engine registers grouped and flat on the decode axis,
    not the kernel variant (it has no pages; a pinned cuda records
    grouped), and neither the prefill-kernel nor the layout axis."""
    from repro_torch.core import VPE
    _, tcfg, _, tp = setup
    vpe = VPE(controller_kwargs=dict(min_samples=1, trial_samples=1))
    eng = tserve.ContinuousBatchingEngine(tcfg, tp, slots=2, max_len=64, vpe=vpe,
                                          device="cpu")
    _serve(eng, tserve, tcfg.vocab_size, n=3)
    assert set(vpe.registry.op("serve_decode_impl").variants) == {"grouped", "flat"}
    assert not vpe.registry.has_op("prefill_kernel")
    assert not vpe.registry.has_op("kv_layout")
    vpe2 = VPE()
    eng = tserve.ContinuousBatchingEngine(tcfg, tp, slots=2, max_len=64, vpe=vpe2,
                                          decode_impl="cuda", device="cpu")
    _serve(eng, tserve, tcfg.vocab_size, n=2)
    measured = {v for b in vpe2.profiler.buckets_seen("serve_decode_impl")
                for v in vpe2.profiler.variants_measured("serve_decode_impl", b)}
    assert measured == {"grouped"}


def test_engine_default_layout_is_contiguous(setup):
    """The reference's default: ``kv_layout="contiguous"`` (no page pool),
    and a ``max_len`` off the block size is fine without pages."""
    _, tcfg, _, tp = setup
    eng = tserve.ContinuousBatchingEngine(tcfg, tp, slots=1, max_len=50,
                                          device="cpu")
    assert eng.kv_layout == "contiguous" and eng.pages is None
    assert eng.cache["k"].shape[3] == 50 and eng.cache["k"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tserve.ContinuousBatchingEngine(tcfg, tp, slots=1, max_len=50,
                                        kv_layout="auto", device="cpu")
    with pytest.raises(ValueError):
        tserve.ContinuousBatchingEngine(tcfg, tp, slots=1, max_len=64,
                                        kv_layout="blocked", device="cpu")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_keeps_first_logits_when_asked(setup, layout):
    """``first_logits`` is None by default and keeps nothing; set to a dict,
    it holds each admission's prompt-last-position logits (V,) by request
    id, whose argmax is the request's first token."""
    _, tcfg, _, tp = setup
    kw = dict(prefill_chunk=8, block_size=8) if layout == "paged" else {}
    eng = tserve.ContinuousBatchingEngine(tcfg, tp, slots=2, max_len=64,
                                          kv_layout=layout, device="cpu", **kw)
    _serve(eng, tserve, tcfg.vocab_size, n=2)
    assert eng.first_logits is None
    eng.completed.clear()
    eng.first_logits = {}
    out = _serve(eng, tserve, tcfg.vocab_size, n=3)
    assert sorted(eng.first_logits) == sorted(out)
    for rid, x in eng.first_logits.items():
        assert x.shape == (tcfg.vocab_size,)
        assert int(torch.argmax(x)) == out[rid][0]


@pytest.mark.parametrize("max_len,total,levels", [(64, 2, 4), (1024, 4, 4),
                                                   (40, 3, 2)])
def test_kv_layout_buckets_are_the_distinct_keys(max_len, total, levels):
    """``kv_layout_buckets`` lists each key the reference's
    ``kv_layout_bucket`` gives a warm admission exactly once."""
    from repro.core import kv_layout_bucket
    from repro_torch.core import kv_layout_buckets
    got = kv_layout_buckets(max_len, total, levels=levels)
    want = {kv_layout_bucket(m, occ, total, levels=levels)
            for m in range(1, max_len) for occ in range(total + 1)}
    assert len(got) == len(set(got)) and set(got) == want


# -- the launcher ------------------------------------------------------------------

@pytest.mark.parametrize("argv,expect", [
    (["--continuous", "--kv-layout", "contiguous"], "completed 3 requests; "),
    (["--continuous", "--kv-layout", "auto", "--prefix-cache", "--prefix-blocks",
      "8"], "kv_layout"),
    ([], "decode throughput")], ids=["contiguous", "auto-prefix", "wave"])
def test_launcher_layouts_and_wave(capsys, argv, expect):
    """The launcher's contiguous and ``auto`` + prefix-cache paths, and the
    wave path without ``--continuous`` (the reference's default), on the
    CPU."""
    tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                  "--requests", "3", "--new-tokens", "3", "--max-len", "48",
                  *argv])
    out = capsys.readouterr().out
    assert "completed 3 requests" in out and expect in out
    if "--prefix-cache" in argv:
        assert "prefix-cache 0/3 hits" in out


def test_launcher_chunk_axis_still_raises(capsys):
    """``--prefill-chunk auto`` now serves through the measured chunk axis
    (its rows in the decision table); a chunk that is neither a count,
    ``whole`` nor ``auto`` still raises."""
    tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                  "--continuous", "--kv-layout", "paged", "--requests", "3",
                  "--new-tokens", "3", "--max-len", "48", "--prefill-chunk",
                  "auto"])
    out = capsys.readouterr().out
    assert "completed 3 requests" in out and "prefill_chunk" in out
    with pytest.raises(ValueError):
        tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                      "--continuous", "--kv-layout", "paged",
                      "--prefill-chunk", "sometimes"])
