"""The port's recurrent families against ``repro``'s, on the CPU in f32.

The scans first, as tests/test_recurrent.py checks them, each beside its
JAX counterpart on the same numpy inputs: SSD and WKV chunked against
sequential at several chunks, a block's training pass against its
decode steps, the channel mix's token shift, and the chunk checks raising
on the lengths where the reference's asserts fail.  Then the families —
ssm (rwkv6-7b) and hybrid (zamba2-1.2b, reduced: 4 layers without a mamba
tail, and 5 layers with one) — on parameters converted from the
reference's (``params_from_jax``): forward logits, the loss and its
gradients, prefill logits and every cache leaf, 8 decode steps (logits
and every cache leaf with its dtype), greedy tokens of ``ServeLoop`` +
``WaveScheduler`` against the JAX pair; for the hybrid also
``attn_impl="flash_cuda"`` (the kernel's plain version here) against
JAX's ``flash_pallas`` (interpret mode), and the flash launches of a
training step; and ``TrainLoop`` over the reference's axes.

Tolerances: logits, losses and f32 state leaves within 1e-4 (f32 sums in
another order), gradients within 1e-4 as in test_torch_moe.py, tokens
exact.  A bf16 cache leaf (the hybrid's K/V) may sit one bf16 step from
the reference's where an f32 value ~1e-6 away from it rounds to the other
neighbour, and what is computed from it then differs at bf16's scale; so
the decode steps run twice: with the K/V held in f32 on both sides (within
1e-4), and in the declared dtypes (within one bf16 step, 2**-7).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rwkv6 as jr6  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rwkv6 as tr6  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402

torch.set_num_threads(1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_STEP = dict(rtol=2 ** -7, atol=2 ** -7)
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().float().numpy()


def assert_cache_equal(got, want, tol):
    """Every leaf of the port's cache against the reference's: same dtype
    and shape, bf16 leaves within one bf16 step, the others within
    ``tol``."""
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        name = jax.tree_util.keystr(path)
        assert str(node.dtype).removeprefix("torch.") == w.dtype.name, name
        assert tuple(node.shape) == w.shape, name
        np.testing.assert_allclose(
            _np(node), np.asarray(w, np.float32), err_msg=name,
            **(BF16_STEP if w.dtype.name == "bfloat16" else tol))


# -- the scans, as tests/test_recurrent.py --------------------------------------

def _ssd_inputs(seed, B=2, S=64, H=4, P=8, N=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(B, S, H)))
    log_a = -dt * np.exp(f(H))
    return f(B, S, H, P), f(B, S, N), f(B, S, N), log_a, dt, f(B, H, P, N) * 0.1


class TestSSD:
    @pytest.mark.parametrize("chunk", [8, 16, 32, 64])
    def test_chunked_equals_sequential(self, chunk):
        js = jm2.Mamba2Spec(d_model=16, ssm_state=8, head_dim=8, chunk=chunk)
        ts = tm2.Mamba2Spec(**dataclasses.asdict(js))
        args = _ssd_inputs(chunk)
        jy, jh = jm2._ssd_chunked(js, *map(jnp.asarray, args))
        y1, h1 = tm2._ssd_chunked(ts, *map(_t, args))
        y2, h2 = tm2._ssd_sequential(ts, *map(_t, args))
        np.testing.assert_allclose(_np(y1), np.asarray(jy), **LOGIT_TOL)
        np.testing.assert_allclose(_np(h1), np.asarray(jh), **LOGIT_TOL)
        np.testing.assert_allclose(_np(y1), _np(y2), **LOGIT_TOL)
        np.testing.assert_allclose(_np(h1), _np(h2), **LOGIT_TOL)

    def test_block_train_equals_decode_and_reference(self):
        js = jm2.Mamba2Spec(d_model=32, ssm_state=8, head_dim=8, chunk=8)
        ts = tm2.Mamba2Spec(**dataclasses.asdict(js))
        jp = jm2.init_mamba2(jax.random.PRNGKey(0), js, jnp.float32)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        x = np.random.default_rng(0).standard_normal((2, 16, 32)).astype(np.float32)
        jy = jax.jit(lambda p, x: jm2.mamba2_block(p, js, x)[0])(jp, jnp.asarray(x))
        y_full, _ = tm2.mamba2_block(tp, ts, _t(x))
        np.testing.assert_allclose(_np(y_full), np.asarray(jy), **LOGIT_TOL)
        st = tm2.init_mamba2_state(ts, 2, torch.float32, device=CPU)
        ys = []
        for t in range(16):
            yt, st = tm2.mamba2_block(tp, ts, _t(x[:, t:t + 1]), state=st)
            ys.append(yt)
        np.testing.assert_allclose(_np(y_full), _np(torch.cat(ys, 1)),
                                   rtol=2e-3, atol=2e-3)

    def test_chunk_check_raises_where_the_reference_asserts(self):
        js = jm2.Mamba2Spec(d_model=16, ssm_state=8, head_dim=8, chunk=16)
        ts = tm2.Mamba2Spec(**dataclasses.asdict(js))
        args = _ssd_inputs(0, S=24)
        with pytest.raises(AssertionError):
            jm2._ssd_chunked(js, *map(jnp.asarray, args))
        with pytest.raises(ValueError, match="not a multiple of the chunk 16"):
            tm2._ssd_chunked(ts, *map(_t, args))
        # shorter than a chunk: one chunk of S, on both sides
        args = _ssd_inputs(0, S=12)
        jy, _ = jm2._ssd_chunked(js, *map(jnp.asarray, args))
        np.testing.assert_allclose(_np(tm2._ssd_chunked(ts, *map(_t, args))[0]),
                                   np.asarray(jy), **LOGIT_TOL)

    def test_gradient_finite_where_the_reference_overflows(self):
        """A chunk of 128 steps of dt ~0.8 overflows exp above the diagonal:
        the reference's gradient through log_a is NaN there, the port's is
        finite; at a chunk that does not overflow the two agree."""
        for chunk, overflows in ((128, True), (16, False)):
            js = jm2.Mamba2Spec(d_model=16, ssm_state=8, head_dim=8, chunk=chunk)
            ts = tm2.Mamba2Spec(**dataclasses.asdict(js))
            xh, Bm, Cm, _, _, h0 = _ssd_inputs(1, B=1, S=128)
            dt = np.full((1, 128, 4), 0.8, np.float32)
            jg = jax.grad(lambda la: jm2._ssd_chunked(
                js, *map(jnp.asarray, (xh, Bm, Cm)), la, jnp.asarray(dt),
                jnp.asarray(h0))[0].sum())(jnp.asarray(-dt))
            la = _t(-dt).requires_grad_()
            tm2._ssd_chunked(ts, _t(xh), _t(Bm), _t(Cm), la, _t(dt), _t(h0))[0].sum().backward()
            assert bool(jnp.isnan(jg).any()) == overflows
            assert torch.isfinite(la.grad).all()
            if not overflows:
                np.testing.assert_allclose(_np(la.grad), np.asarray(jg), **GRAD_TOL)


def _wkv_inputs(seed, B=2, T=32, H=4, K=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = (1.0 / (1.0 + np.exp(-f(B, T, H, K)))) * 0.98 + 0.01
    return f(B, T, H, K), f(B, T, H, K), f(B, T, H, K), w.astype(np.float32), \
        f(H, K) * 0.1, f(B, H, K, K) * 0.1


class TestWKV:
    @pytest.mark.parametrize("chunk", [4, 8, 16])
    def test_chunked_equals_sequential(self, chunk):
        args = _wkv_inputs(chunk)
        jo, jS = jr6._wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
        o1, S1 = tr6._wkv_chunked(*map(_t, args), chunk=chunk)
        o2, S2 = tr6._wkv_sequential(*map(_t, args))
        np.testing.assert_allclose(_np(o1), np.asarray(jo), **LOGIT_TOL)
        np.testing.assert_allclose(_np(S1), np.asarray(jS), **LOGIT_TOL)
        np.testing.assert_allclose(_np(o1), _np(o2), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(_np(S1), _np(S2), rtol=1e-3, atol=1e-3)

    def test_chunk_check_raises_where_the_reference_asserts(self):
        args = _wkv_inputs(0, T=20)
        with pytest.raises(AssertionError):
            jr6._wkv_chunked(*map(jnp.asarray, args), chunk=8)
        with pytest.raises(ValueError, match="not a multiple of the chunk 8"):
            tr6._wkv_chunked(*map(_t, args), chunk=8)

    def test_time_mix_train_equals_decode_and_reference(self):
        js = jr6.RWKV6Spec(d_model=64, d_ff=128, head_dim=16, chunk=8)
        ts = tr6.RWKV6Spec(**dataclasses.asdict(js))
        jp = jr6.init_rwkv6(jax.random.PRNGKey(0), js, jnp.float32)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        x = np.random.default_rng(0).standard_normal((2, 16, 64)).astype(np.float32)
        jy = jax.jit(lambda p, x: jr6.rwkv6_time_mix(p, js, x)[0])(jp, jnp.asarray(x))
        y_full, _ = tr6.rwkv6_time_mix(tp, ts, _t(x))
        np.testing.assert_allclose(_np(y_full), np.asarray(jy), **LOGIT_TOL)
        st = tr6.init_rwkv6_state(ts, 2, torch.float32, device=CPU)
        st = {"x_tm": st["x_tm"], "S": st["S"]}
        ys = []
        for t in range(16):
            yt, st = tr6.rwkv6_time_mix(tp, ts, _t(x[:, t:t + 1]), state=st)
            ys.append(yt)
        np.testing.assert_allclose(_np(y_full), _np(torch.cat(ys, 1)),
                                   rtol=2e-3, atol=2e-3)

    def test_channel_mix_token_shift(self):
        """First position sees a zero shift; later positions see x_{t-1}."""
        js = jr6.RWKV6Spec(d_model=64, d_ff=128, head_dim=16)
        ts = tr6.RWKV6Spec(**dataclasses.asdict(js))
        jp = jr6.init_rwkv6(jax.random.PRNGKey(0), js, jnp.float32)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        x = np.random.default_rng(0).standard_normal((1, 4, 64)).astype(np.float32)
        y, _ = tr6.rwkv6_channel_mix(tp, ts, _t(x))
        jy, _ = jr6.rwkv6_channel_mix(jp, js, jnp.asarray(x))
        np.testing.assert_allclose(_np(y), np.asarray(jy), **LOGIT_TOL)
        x2 = np.concatenate([x[:, :1] * 0, x[:, :-1]], axis=1)
        y2, _ = tr6.rwkv6_channel_mix(tp, ts, _t(x2))
        np.testing.assert_allclose(_np(y[:, 1]), _np(y2[:, 2]), **LOGIT_TOL)


# -- the families --------------------------------------------------------------

def _reduced(name):
    """reduced() of both packages; ``zamba2-1.2b-tail`` is zamba2's at 5
    layers: 2 macros of (1 mamba + shared attention) and a 1-layer tail."""
    base = name.removesuffix("-tail")
    cfg, tcfg = ARCHS[base].reduced(), get_config(base).reduced()
    if name.endswith("-tail"):
        cfg = dataclasses.replace(cfg, num_layers=5)
        tcfg = dataclasses.replace(tcfg, num_layers=5)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    return cfg, tcfg


def _family(made, name):
    """(cfg, tcfg, JAX params, converted params, batch) of a reduced arch,
    made once a module (``made`` is the module's cache)."""
    if name not in made:
        cfg, tcfg = _reduced(name)
        jp = jax.jit(lambda key: jmodel.init_params(cfg, key))(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
        made[name] = (cfg, tcfg, jp, tp,
                      {"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    return made[name]


@pytest.fixture(scope="module")
def made():
    return {}


# every case: the hybrid with and without a mamba tail (an empty tail's
# stacks and states are cases of their own); the forward, gradient and
# serving checks take the one with a tail, which runs everything the other
# runs
@pytest.fixture(scope="module", params=["rwkv6-7b", "zamba2-1.2b", "zamba2-1.2b-tail"])
def family(request, made):
    return _family(made, request.param)


@pytest.fixture(scope="module", params=["rwkv6-7b", "zamba2-1.2b-tail"])
def arch(request, made):
    return _family(made, request.param)


def test_param_tree_and_count(family):
    cfg, tcfg, jp, tp, _ = family
    assert tcfg.param_count() == cfg.param_count()
    shapes = tmodel.param_shapes(tcfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node, shape = tp, shapes
        for key in path:
            node, shape = node[key.key], shape[key.key]
        assert tuple(node.shape) == leaf.shape == shape
    # the port's own init: the same tree, f32 leaves f32 in a bf16 model
    init = tmodel.init_params(dataclasses.replace(tcfg, dtype="bfloat16"),
                              torch.Generator("cpu").manual_seed(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = init
        for key in path:
            node = node[key.key]
        key = path[-1].key
        f32 = key in ("m_A_log", "m_D", "m_dt_bias", "w_base", "w_lora_a",
                      "w_lora_b", "u")
        assert node.dtype == (torch.float32 if f32 else torch.bfloat16), key
        assert tuple(node.shape) == leaf.shape


def test_forward_matches_reference(arch):
    cfg, tcfg, jp, tp, batch = arch
    want = jmodel.forward(cfg, jp, {"tokens": jnp.asarray(batch["tokens"])})
    got = tmodel.forward(tcfg, tp, {"tokens": _t(batch["tokens"])})
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


def test_loss_and_grads_match_reference(arch):
    cfg, tcfg, jp, tp, batch = arch
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(
        cfg, p, jax.tree.map(jnp.asarray, batch))))(jp)
    leaves, spec = torch.utils._pytree.tree_flatten(tp)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = tmodel.loss_fn(tcfg, torch.utils._pytree.tree_unflatten(leaves, spec),
                          {k: _t(v) for k, v in batch.items()})
    grads = torch.utils._pytree.tree_unflatten(list(torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)), spec)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)
    for path, w in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        node = grads
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(_np(node), np.asarray(w), err_msg=str(path),
                                   **GRAD_TOL)


def _with_f32_kv(jcache):
    """The reference's cache with its bf16 K/V held in f32."""
    return {k: (v.astype(jnp.float32) if k in ("k", "v") else v)
            for k, v in jcache.items()}


def _decode_steps(cfg, tcfg, jp, tp, jcache, toks, tol):
    """8 greedy-fed decode steps on both sides from the same cache: logits
    and every leaf (dtype and shape equal, values within ``tol``)."""
    cache = params_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    decode = jax.jit(lambda c, t: jmodel.decode_step(cfg, jp, c, t))
    for i in range(8):
        tok = toks[:, i:i + 1]
        cache, logits = tmodel.decode_step(tcfg, tp, cache, _t(tok))
        jcache, jl = decode(jcache, jnp.asarray(tok))
        np.testing.assert_allclose(_np(logits), np.asarray(jl), **tol)
        assert_cache_equal(cache, jcache, tol)


def test_prefill_and_decode_steps_match_reference(family):
    """Prefill: last logits and every cache leaf.  Then 8 decode steps, (a)
    with the K/V held in f32 on both sides (each step's arithmetic, no bf16
    rounding), within 1e-4; (b) in the declared dtypes (a conv or
    token-shift state declared bf16 comes back f32 in this f32 model, as
    the reference's does), within one bf16 step."""
    cfg, tcfg, jp, tp, batch = family
    toks = batch["tokens"][:, :16]
    jcache = jmodel.init_cache(cfg, 2, 32)
    jcache, jl = jmodel.prefill(cfg, jp, {"tokens": jnp.asarray(toks)}, jcache)
    cache = tmodel.init_cache(tcfg, 2, 32, CPU)
    cache, logits = tmodel.prefill(tcfg, tp, {"tokens": _t(toks)}, cache)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **LOGIT_TOL)
    assert_cache_equal(cache, jcache, LOGIT_TOL)
    steps = batch["tokens"][:, 16:24]
    _decode_steps(cfg, tcfg, jp, tp, _with_f32_kv(jcache), steps, LOGIT_TOL)
    if "k" in jcache:             # the ssm family has no bf16 leaf to round
        _decode_steps(cfg, tcfg, jp, tp, jcache, steps, BF16_STEP)


def test_wave_serving_tokens_match_reference(arch):
    """``ServeLoop`` + ``WaveScheduler``: three requests in two waves of 2,
    left-padded with token 0 to a wave's longest prompt (a multiple of
    both chunks), greedy tokens equal."""
    cfg, tcfg, jp, tp, batch = arch
    lens = (16, 11, 8)
    outs = []
    for mod, params, c, kw in ((jserve, jp, cfg, {}), (tserve, tp, tcfg, {"device": "cpu"})):
        sched = mod.WaveScheduler(mod.ServeLoop(c, params, max_len=32, batch=2, **kw))
        for i, n in enumerate(lens):
            sched.submit(mod.Request(rid=i, prompt=batch["tokens"][i % 2, :n],
                                     max_new_tokens=6))
        outs.append({r.rid: list(r.out) for r in sched.run()})
    assert outs[0] == outs[1]


def test_flash_matches_reference_flash():
    """The hybrid's shared block under ``flash_cuda`` (the plain version
    here) against JAX's ``flash_pallas`` (interpret mode): forward and
    prefill logits, with a mamba tail."""
    cfg, tcfg = _reduced("zamba2-1.2b-tail")
    jcfg = dataclasses.replace(cfg, attn_impl="flash_pallas")
    tcfg = dataclasses.replace(tcfg, attn_impl="flash_cuda")
    jp = jax.jit(lambda key: jmodel.init_params(cfg, key))(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    want = jmodel.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = tmodel.forward(tcfg, tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    _, jl = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                           jmodel.init_cache(jcfg, 1, 32))
    _, logits = tmodel.prefill(tcfg, tp, {"tokens": _t(toks)},
                               tmodel.init_cache(tcfg, 1, 32, CPU))
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("remat,per_macro", [("full", 2), ("none", 1)])
def test_hybrid_flash_launches_per_step(monkeypatch, remat, per_macro):
    """One flash call a shared-block application in the forward and one
    more in its recomputation under remat (the count the card run gates:
    12 a step for full zamba2-1.2b)."""
    _, tcfg = _reduced("zamba2-1.2b-tail")
    calls = []
    real = tfa.flash_attention_cuda
    monkeypatch.setattr(tfa, "flash_attention_cuda",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    c = dataclasses.replace(tcfg, remat=remat)
    params = tmodel.init_params(c, torch.Generator("cpu").manual_seed(0))
    step = ttrain.make_train_step(c, adamw.AdamWConfig(),
                                  impl={"attn_impl": "flash_cuda"})
    toks = torch.randint(0, c.vocab_size, (1, 16), generator=torch.Generator().manual_seed(1))
    step(params, ttrain.init_opt_state(adamw.AdamWConfig(), params),
         {"tokens": toks, "labels": toks.roll(-1, 1)}, 1e-3)
    assert len(calls) == per_macro * (c.num_layers // c.attn_every) == per_macro * 2


def test_impl_axes_are_the_reference_s():
    rename = {"flash_pallas": "flash_cuda"}
    want = {fam: {axis: [rename.get(v, v) for v in vs] for axis, vs in axes.items()}
            for fam, axes in jtrain.IMPL_AXES.items()}
    assert ttrain.IMPL_AXES == want


@pytest.mark.parametrize("name,axis", [("rwkv6-7b", "wkv_impl"),
                                       ("zamba2-1.2b", "ssd_impl")])
def test_train_loop_trials_the_scan_axis(monkeypatch, name, axis):
    """The loop trials the family's scan variants, and the rebound step
    runs the variant the VPE selects (``dataclasses.replace(cfg, **impl)``)."""
    cfg = get_config(name).reduced()
    seen = []
    real = tmodel.loss_fn
    monkeypatch.setattr(tmodel, "loss_fn", lambda c, p, b: seen.append(
        getattr(c, axis)) or real(c, p, b))
    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                      global_batch=2))
    loop = ttrain.TrainLoop(cfg, ttrain.TrainLoopConfig(total_steps=10, log_every=0,
                                                        watchdog=False),
                            data, device="cpu")
    metrics = loop.run()
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert set(seen) == {"chunked", "sequential"}
    assert loop.vpe.controller.decision(axis, ("static",)).selected in (
        "chunked", "sequential")
