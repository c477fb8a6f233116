"""The port's flash attention against the JAX package's, on seeded numpy
inputs.

``kernels.flash_attention.flash_attention_cuda`` (its CPU path: the same
padding around the plain version) and ``kernels.ref.attention_ref`` are
held against ``repro.kernels.ops.flash_attention`` (the Pallas kernel in
interpret mode, as the JAX tests run it) and ``repro.kernels.ref.
attention_ref``; the gradient of ``layers.attention_flash`` against
``jax.vjp`` of the reference's ``attention_flash``; and
``layers.attention_chunked`` against the reference's with chunking forced.

Tolerances: f32 sums the same products in another order (worst observed
difference 1.2e-6 forward, 1.5e-6 in the gradients; bound 1e-5).  bf16
rounds an f32 result that may differ in its last bits, so an output can
land one bf16 step away (worst observed 1.95e-3; bound 4e-3 absolute and
relative).  Gradients are compared in f32 only: in bf16 the two
frameworks round the backward's intermediates at different places.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

torch.set_num_threads(1)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=4e-3, atol=4e-3)}

# (S, T, Hq, Hkv, D, causal, window): GQA groups 1 and 4, danube's D=120,
# S < T (rows aligned at the end) and T off the 64-key tile (padded)
CASES = [
    (64, 64, 4, 4, 32, True, None),
    (64, 64, 8, 2, 120, True, None),
    (64, 64, 8, 2, 120, True, 24),
    (40, 72, 4, 1, 32, True, None),
    (40, 72, 8, 2, 120, True, 24),
    (48, 48, 4, 4, 120, False, None),
    (24, 90, 4, 1, 32, False, 30),
    (1, 77, 8, 2, 120, True, None),
]


def _inputs(S, T, Hq, Hkv, D, seed=0, B=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32))


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,Hq,Hkv,D,causal,window", CASES)
def test_flash_matches_pallas(S, T, Hq, Hkv, D, causal, window, dtype):
    arrs = _inputs(S, T, Hq, Hkv, D)
    want = jops.flash_attention(*(_jax(a, dtype) for a in arrs),
                                causal=causal, window=window)
    got = tfa.flash_attention_cuda(*(_torch(a, dtype) for a in arrs),
                                   causal=causal, window=window)
    assert got.shape == (1, Hq, S, D) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert tfa.flash_attention_cuda.launches == 0       # no kernel on the CPU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,Hq,Hkv,D,causal,window", CASES[:5])
def test_attention_ref_matches_reference(S, T, Hq, Hkv, D, causal, window, dtype):
    arrs = _inputs(S, T, Hq, Hkv, D, seed=1)
    want = jref.attention_ref(*(_jax(a, dtype) for a in arrs),
                              causal=causal, window=window)
    got = tref.attention_ref(*(_torch(a, dtype) for a in arrs),
                             causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_fully_masked_rows_give_zero():
    """S > T leaves the first rows with no valid column: the kernel's rule
    (and the Pallas kernel's) is a zero row."""
    arrs = _inputs(70, 6, 4, 2, 32, seed=2)
    want = jops.flash_attention(*(jnp.asarray(a) for a in arrs), causal=True)
    got = tfa.flash_attention_cuda(*(torch.from_numpy(a) for a in arrs), causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    assert not got[:, :, :64].any()


@pytest.mark.parametrize("S,T,Hq,Hkv,D,causal,window", [CASES[1], CASES[4], CASES[6]])
def test_flash_gradient_matches_reference(S, T, Hq, Hkv, D, causal, window):
    q, k, v = _inputs(S, T, Hq, Hkv, D, seed=3)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: jlayers.attention_flash(
        q, k, v, causal=causal, window=window), *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got_out = tlayers.attention_flash(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(_np(got_out), _np(out), **TOL["float32"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,q_chunk,causal,window", [
    (48, 48, 16, True, None),      # three chunks of 16
    (40, 40, 16, True, 12),        # largest divisor of 40 up to 16: 10
    (32, 56, 8, False, None),      # S < T, rows aligned at the end
])
def test_attention_chunked_matches_reference(S, T, q_chunk, causal, window, dtype):
    """Chunking forced (S > q_chunk), including the rounding of p to v's
    dtype before the value product: the forward in both dtypes, the
    gradients in f32."""
    q, k, v = _inputs(S, T, 8, 2, 32, seed=5)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)

    def jfn(q, k, v):
        return jlayers.attention_chunked(q, k, v, causal=causal, window=window,
                                         q_chunk=q_chunk)

    out, vjp = jax.vjp(jfn, *(_jax(a, dtype) for a in (q, k, v)))
    want = vjp(_jax(g, dtype))
    tq, tk, tv = (_torch(a, dtype).requires_grad_() for a in (q, k, v))
    got_out = tlayers.attention_chunked(tq, tk, tv, causal=causal, window=window,
                                        q_chunk=q_chunk)
    got = torch.autograd.grad(got_out, (tq, tk, tv), _torch(g, dtype))
    np.testing.assert_allclose(_np(got_out), _np(out), **TOL[dtype])
    if dtype == "float32":
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), **TOL[dtype])


def test_flash_and_chunked_agree_to_bf16_rounding():
    """In bf16 the kernel keeps p in f32 while ``reference`` rounds it to
    bf16 before the value product, so the two variants agree only to bf16
    rounding (worst observed 1.6e-2; like with like, each is held to its
    own JAX counterpart above)."""
    arrs = _inputs(64, 64, 8, 2, 120, seed=7)
    q, k, v = (_torch(a, "bfloat16") for a in arrs)
    flash = tlayers.attention_flash(q, k, v, causal=True).float()
    chunked = tlayers.attention_chunked(q, k, v, causal=True, q_chunk=16).float()
    np.testing.assert_allclose(flash.numpy(), chunked.numpy(), rtol=3e-2, atol=3e-2)


# the wrapper's padding for the bf16 body's tiles: head dims off the
# multiple of 8 (zero dims, the real head dim's scale), S and T off the
# 128-row and 64-key tiles (S < T, S > 128, S < 64)
PAD_CASES = [
    (130, 250, 8, 1, 100, True, None),
    (70, 70, 4, 2, 60, True, 24),
    (129, 129, 4, 4, 36, False, None),
    (20, 90, 4, 2, 12, False, 30),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,Hq,Hkv,D,causal,window", PAD_CASES)
def test_flash_padding_matches_pallas_and_reference(S, T, Hq, Hkv, D, causal, window,
                                                   dtype):
    arrs = _inputs(S, T, Hq, Hkv, D, seed=9)
    got = tfa.flash_attention_cuda(*(_torch(a, dtype) for a in arrs),
                                   causal=causal, window=window)
    assert got.shape == (1, Hq, S, D) and got.dtype == getattr(torch, dtype)
    for want in (jops.flash_attention(*(_jax(a, dtype) for a in arrs), causal=causal,
                                      window=window),
                 jref.attention_ref(*(_jax(a, dtype) for a in arrs), causal=causal,
                                    window=window)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype,rows,dims", [("float32", (192, 256), 100),
                                             ("bfloat16", (256, 256), 104)])
def test_flash_wrapper_pads_to_the_dtypes_tiles(monkeypatch, dtype, rows, dims):
    """What the kernel (here its plain version) is handed: S and T padded
    to the dtype's q and k tiles, bf16 head dims to a multiple of 8, the
    keys' end and the rows' alignment passed on, the real head dim's
    scale."""
    seen = {}
    real = tref.attention_ref

    def spy(q, k, v, **kw):
        seen.update(q=tuple(q.shape), k=tuple(k.shape), v=tuple(v.shape), **kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(tfa.ref, "attention_ref", spy)
    q, k, v = (_torch(a, dtype) for a in _inputs(130, 250, 4, 2, 100, seed=10))
    out = tfa.flash_attention_cuda(q, k, v, causal=True)
    assert seen["q"] == (1, 4, rows[0], dims)
    assert seen["k"] == seen["v"] == (1, 2, rows[1], dims)
    assert (seen["t_valid"], seen["q_offset"]) == (250, 120)
    assert seen["scale"] == pytest.approx(100 ** -0.5)
    assert out.shape == (1, 4, 130, 100)
