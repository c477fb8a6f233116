"""Port layers against ``repro.models.layers`` on seeded numpy inputs (f32,
atol/rtol 1e-5: the same arithmetic, summed in another order)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as J  # noqa: E402
from repro_torch.models import layers as T  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def data(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def check(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_rmsnorm():
    x, g = data(2, 5, 64), data(64, seed=1)
    check(T.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-6),
          J.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-6))


@pytest.mark.parametrize("positions", [np.arange(7), np.array([[3], [40]]),
                                       np.array([[0, 1, 2], [9, 10, 11]])])
def test_apply_rope_interleaved(positions):
    """Rotates pairs (x[..., 0::2], x[..., 1::2]) at 1-D and per-row
    positions, as the reference does."""
    B = 1 if positions.ndim == 1 else positions.shape[0]
    S = positions.shape[-1]
    x = data(B, 3, S, 32)
    check(T.apply_rope(torch.from_numpy(x), torch.from_numpy(positions), 1e6),
          J.apply_rope(jnp.asarray(x), jnp.asarray(positions), 1e6))


@pytest.mark.parametrize("qkv_bias,qk_norm,window", [
    (False, True, None), (True, False, None), (False, False, 16)])
def test_attn_qkv(qkv_bias, qk_norm, window):
    spec = T.AttnSpec(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                      qkv_bias=qkv_bias, qk_norm=qk_norm, window=window,
                      rope_theta=1e4)
    jspec = J.AttnSpec(**dataclasses.asdict(spec))
    shapes = T.attn_param_shapes(spec)
    assert shapes == J.attn_param_shapes(jspec)
    p = {k: data(*s, seed=i) for i, (k, s) in enumerate(sorted(shapes.items()))}
    x, pos = data(2, 6, 64, seed=9), np.arange(3, 9)
    got = T.attn_qkv({k: torch.from_numpy(v) for k, v in p.items()}, spec,
                     torch.from_numpy(x), torch.from_numpy(pos))
    want = J.attn_qkv({k: jnp.asarray(v) for k, v in p.items()}, jspec,
                      jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        check(g, w)


def test_swiglu():
    shapes = T.swiglu_param_shapes(32, 48)
    assert shapes == J.swiglu_param_shapes(32, 48)
    p = {k: data(*s, seed=i) for i, (k, s) in enumerate(sorted(shapes.items()))}
    x = data(2, 3, 32, seed=7)
    check(T.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                   torch.from_numpy(x)),
          J.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


def test_merge_split_heads_roundtrip():
    x = torch.from_numpy(data(2, 5, 4 * 8))
    h = T._split_heads(x, 4, 8)
    assert h.shape == (2, 4, 5, 8)
    check(h, J._split_heads(jnp.asarray(x.numpy()), 4, 8))
    check(T._merge_heads(h), x.numpy())


def test_dense_init_statistics():
    """The port draws its own weights (torch.Generator): same shape,
    dtype and scale as the reference's initialiser, from a fixed seed."""
    g = torch.Generator("cpu").manual_seed(0)
    w = T.dense_init(g, 256, 512, torch.bfloat16)
    assert w.shape == (256, 512) and w.dtype == torch.bfloat16
    assert abs(w.float().std().item() - 1 / 16) < 2e-3
    w2 = T.dense_init(torch.Generator("cpu").manual_seed(0), 256, 512,
                      torch.bfloat16)
    assert torch.equal(w, w2)
