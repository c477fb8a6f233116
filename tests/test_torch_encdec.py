"""The port's encoder-decoder family (whisper-base) against ``repro``'s, on
the CPU in f32.

Reduced whisper-base (2 + 2 layers, 24 source frames) on parameters
converted from the reference's (``params_from_jax``) and frames and tokens
from a numpy seed, with 32 decoder tokens against the 24 frames (S > T in
the cross-attention) and 16 (S < T): the GELU MLP; forward logits; the
loss and its gradients; prefill (last logits, the cross K/V, and the
decoder's self-attention cache left empty at length 0, as the reference
leaves it); 8 decode steps, logits and every cache leaf with its dtype;
greedy tokens of ``ServeLoop.generate`` with {"tokens", "frames"} against
the JAX loop; ``attn_impl="flash_cuda"`` (the kernel's plain version here)
against JAX's ``flash_pallas`` (interpret mode); the flash launches of a
backward pass; and the refusals (frames of another dtype, the launchers).

Tolerances as in test_torch_recurrent.py: 1e-4 for logits, losses,
gradients and f32 leaves; the bf16 K/V within one bf16 step (2**-7), and
the decode steps run with the self-attention K/V held in f32 on both sides
(within 1e-4) and in the declared dtypes (within one bf16 step).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch import serve as tlaunch_serve  # noqa: E402
from repro_torch.launch import train as tlaunch_train  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

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
    for key, w in want.items():
        assert str(got[key].dtype).removeprefix("torch.") == w.dtype.name, key
        assert tuple(got[key].shape) == w.shape, key
        np.testing.assert_allclose(
            _np(got[key]), np.asarray(w, np.float32), err_msg=key,
            **(BF16_STEP if w.dtype.name == "bfloat16" else tol))


@pytest.fixture(scope="module")
def whisper():
    cfg, tcfg = ARCHS["whisper-base"].reduced(), get_config("whisper-base").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = jax.jit(lambda key: jmodel.init_params(cfg, key))(jax.random.PRNGKey(0))
    # the QKV biases are zero-initialised: give the bias path real values
    rng = np.random.default_rng(1)
    for stack in ("encoder", "decoder"):
        jp[stack] = {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
                         if "attn_b" in k else v) for k, v in jp[stack].items()}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    frames = rng.standard_normal((2, cfg.source_len, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, jp, tp, toks, frames


def _batch(whisper, S):
    toks, frames = whisper[4], whisper[5]
    return {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1], "frames": frames}


def test_gelu_mlp_is_the_tanh_form():
    jp = jlayers.init_gelu_mlp(jax.random.PRNGKey(0), 32, 64, jnp.float32)
    jp = {k: v + 0.1 for k, v in jp.items()}     # non-zero biases
    x = np.random.default_rng(0).standard_normal((2, 5, 32)).astype(np.float32) * 3
    want = jlayers.gelu_mlp(jp, jnp.asarray(x))
    got = tlayers.gelu_mlp(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), _t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("S", [32, 16])
def test_forward_matches_reference(whisper, S):
    """32 decoder rows against 24 frames (S > T) and 16 (S < T)."""
    cfg, tcfg, jp, tp = whisper[:4]
    batch = _batch(whisper, S)
    want = jmodel.forward(cfg, jp, jax.tree.map(jnp.asarray, batch))
    got = tmodel.forward(tcfg, tp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


def test_loss_and_grads_match_reference(whisper):
    cfg, tcfg, jp, tp = whisper[:4]
    batch = _batch(whisper, 32)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(
        cfg, p, jax.tree.map(jnp.asarray, batch))))(jp)
    leaves, spec = torch.utils._pytree.tree_flatten(tp)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = tmodel.loss_fn(tcfg, torch.utils._pytree.tree_unflatten(leaves, spec),
                          {k: _t(v) for k, v in batch.items()})
    grads = torch.utils._pytree.tree_unflatten(
        list(torch.autograd.grad(loss, leaves)), spec)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)
    for path, w in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        node = grads
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(_np(node), np.asarray(w), err_msg=str(path),
                                   **GRAD_TOL)


def _decode_steps(cfg, tcfg, jp, tp, jcache, toks, tol):
    cache = params_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    decode = jax.jit(lambda c, t: jmodel.decode_step(cfg, jp, c, t))
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        cache, logits = tmodel.decode_step(tcfg, tp, cache, _t(tok))
        jcache, jl = decode(jcache, jnp.asarray(tok))
        np.testing.assert_allclose(_np(logits), np.asarray(jl), **tol)
        assert_cache_equal(cache, jcache, tol)


def test_prefill_and_decode_steps_match_reference(whisper):
    """Prefill: the last logits of the whole-prompt decoder pass, the cross
    K/V in bf16 (f32 model), and the self-attention cache untouched at
    length 0, as the reference leaves it.  Then 8 decode steps from
    position 0, with the self-attention K/V held in f32 on both sides
    (within 1e-4) and in the declared bf16 (within one bf16 step)."""
    cfg, tcfg, jp, tp = whisper[:4]
    batch = _batch(whisper, 32)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    jcache, jl = jmodel.prefill(cfg, jp, jb, jmodel.init_cache(cfg, 2, 48))
    cache, logits = tmodel.prefill(tcfg, tp, {k: _t(batch[k]) for k in jb},
                                   tmodel.init_cache(tcfg, 2, 48, CPU))
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **LOGIT_TOL)
    assert int(cache["length"]) == int(jcache["length"]) == 0
    assert not cache["k"].any() and not cache["v"].any()
    assert cache["xk"].dtype == torch.bfloat16
    assert_cache_equal(cache, jcache, LOGIT_TOL)
    steps = whisper[4][:, 32:40]
    f32_kv = {k: (v.astype(jnp.float32) if k in ("k", "v") else v)
              for k, v in jcache.items()}
    _decode_steps(cfg, tcfg, jp, tp, f32_kv, steps, LOGIT_TOL)
    _decode_steps(cfg, tcfg, jp, tp, jcache, steps, BF16_STEP)


def test_serve_loop_tokens_match_reference(whisper):
    """``ServeLoop.generate`` hands every key of the batch to prefill: the
    frames reach the encoder, and the greedy tokens are the JAX loop's."""
    cfg, tcfg, jp, tp, toks, frames = whisper
    batch = {"tokens": toks[:, :16], "frames": frames}
    want = jserve.ServeLoop(cfg, jp, max_len=32, batch=2).generate(batch, 8)
    got = tserve.ServeLoop(tcfg, tp, max_len=32, batch=2, device="cpu").generate(batch, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_flash_matches_reference_flash(whisper):
    """Every attention under ``flash_cuda`` (the plain version here) against
    JAX's ``flash_pallas``: the encoder's non-causal self-attention, the
    decoder's causal one, and the cross-attention of 32 rows against 24
    frames (the wrapper's row offset T - S = -8): forward and prefill
    logits."""
    cfg, tcfg, jp, tp = whisper[:4]
    jcfg = dataclasses.replace(cfg, attn_impl="flash_pallas")
    tcfg = dataclasses.replace(tcfg, attn_impl="flash_cuda")
    batch = {k: v[:1] for k, v in _batch(whisper, 32).items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    np.testing.assert_allclose(_np(tmodel.forward(tcfg, tp, tb)),
                               np.asarray(jmodel.forward(jcfg, jp, jb)), **LOGIT_TOL)
    _, jl = jmodel.prefill(jcfg, jp, jb, jmodel.init_cache(jcfg, 1, 48))
    _, logits = tmodel.prefill(tcfg, tp, tb, tmodel.init_cache(tcfg, 1, 48, CPU))
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("remat,per_layer", [("full", 2), ("none", 1)])
def test_flash_launches_of_a_backward(whisper, monkeypatch, remat, per_layer):
    """One flash call an attention in the forward (encoder self; decoder
    self and cross) and one more in each layer's recomputation under remat:
    the count the card run gates (36 for full whisper-base)."""
    tcfg, tp = whisper[1], whisper[3]
    calls = []
    real = tfa.flash_attention_cuda
    monkeypatch.setattr(tfa, "flash_attention_cuda",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    c = dataclasses.replace(tcfg, attn_impl="flash_cuda", remat=remat)
    leaves, spec = torch.utils._pytree.tree_flatten(tp)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = tmodel.loss_fn(c, torch.utils._pytree.tree_unflatten(leaves, spec),
                          {k: _t(v) for k, v in _batch(whisper, 16).items()})
    grads = torch.autograd.grad(loss, leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    assert len(calls) == per_layer * (c.encoder_layers + 2 * c.decoder_layers) \
        == per_layer * 6


def test_frames_in_another_dtype_are_refused(whisper):
    tcfg, tp = whisper[1], whisper[3]
    batch = {k: _t(v) for k, v in _batch(whisper, 8).items()}
    batch["frames"] = batch["frames"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="frames are torch.bfloat16"):
        tmodel.forward(tcfg, tp, batch)


@pytest.mark.parametrize("launcher", [tlaunch_serve, tlaunch_train])
def test_launchers_refuse_whisper(launcher, capsys):
    """The reference's launchers build {"tokens"} batches only; the port's
    refuse an encdec arch with a message instead of inventing frames."""
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "whisper-base", "--smoke", "--device", "cpu"])
    assert "has no source of them" in capsys.readouterr().err
