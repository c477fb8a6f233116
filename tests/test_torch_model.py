"""Port model steps against ``repro`` on the same (converted) weights:
``decode_step_paged`` and ``prefill_chunk_paged`` logits and pool
updates on three reduced dense archs (GQA + qk_norm, QKV bias, sliding
window), every attention backend of each package paired with its
counterpart.  f32, logits within 1e-4."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
ARCH_NAMES = ["qwen3-8b", "qwen2-7b", "h2o-danube-3-4b"]
BS, NB, PAGES = 8, 6, 14          # 48 positions per slot: past danube's window


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch(request):
    cfg = ARCHS[request.param].reduced()
    tcfg = get_config(request.param).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    if cfg.qkv_bias:   # zero-initialised: give the bias path real values
        rng = np.random.default_rng(1)
        jp["layers"] = {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.1,
                                        v.dtype) if "attn_b" in k else v)
                        for k, v in jp["layers"].items()}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


def _pool(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, PAGES + 1, cfg.num_kv_heads, BS, cfg.head_dim)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}


def test_convert_roundtrip(arch):
    cfg, tcfg, jp, tp = arch
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    shapes = tmodel.param_shapes(tcfg)
    assert shapes["layers"].keys() == tp["layers"].keys()
    gen = torch.Generator("cpu").manual_seed(0)
    own = tmodel.init_params(tcfg, gen)
    assert jax.tree.map(np.shape, jp) == {
        k: ({kk: tuple(vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
            else tuple(v.shape)) for k, v in own.items()}


@pytest.mark.parametrize("impls", [("grouped", "grouped"), ("flat", "flat"),
                                   ("pallas", "cuda")])
def test_decode_step_paged(arch, impls):
    cfg, tcfg, jp, tp = arch
    pool = _pool(cfg, seed=2)
    rng = np.random.default_rng(3)
    B = 2
    bt = rng.permutation(PAGES)[:B * NB].reshape(B, NB).astype(np.int32)
    length = np.array([29, 41], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    live = np.array([1, 0], np.int32)         # slot 1 writes to the trash
    jpool, jcache, jlogits = jmodel.decode_step_paged(
        cfg, jp, {k: jnp.asarray(v) for k, v in pool.items()},
        {"bt": jnp.asarray(bt), "length": jnp.asarray(length)},
        jnp.asarray(tokens), jnp.asarray(live), decode_impl=impls[0])
    tpool, tcache, tlogits = tmodel.decode_step_paged(
        tcfg, tp, {k: torch.from_numpy(v.copy()) for k, v in pool.items()},
        {"bt": torch.from_numpy(bt), "length": torch.from_numpy(length)},
        torch.from_numpy(tokens), torch.from_numpy(live), decode_impl=impls[1])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
    np.testing.assert_array_equal(tcache["length"].numpy(), length + 1)
    for k in "kv":   # appended rows equal; the trash row is never compared
        np.testing.assert_allclose(tpool[k][:, :PAGES].numpy(),
                                   np.asarray(jpool[k])[:, :PAGES], **KV_TOL)


@pytest.mark.parametrize("kernels", [("gather", "gather"), ("pallas", "cuda")])
@pytest.mark.parametrize("base,clen,pad", [(0, 11, 16), (13, 16, 16), (21, 5, 16)])
def test_prefill_chunk_paged(arch, kernels, base, clen, pad):
    cfg, tcfg, jp, tp = arch
    pool = _pool(cfg, seed=4)
    rng = np.random.default_rng(5)
    n_pages = -(-(base + clen) // BS)
    bt_row = np.full((NB,), PAGES, np.int32)          # trash-padded
    bt_row[:n_pages] = rng.permutation(PAGES)[:n_pages]
    tokens = np.zeros((1, pad), np.int32)
    tokens[0, :clen] = rng.integers(0, cfg.vocab_size, clen)
    jpool, jlogits = jmodel.prefill_chunk_paged(
        cfg, jp, {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(bt_row), jnp.asarray(tokens), jnp.int32(base),
        jnp.int32(clen), kernel=kernels[0])
    tpool, tlogits = tmodel.prefill_chunk_paged(
        tcfg, tp, {k: torch.from_numpy(v.copy()) for k, v in pool.items()},
        torch.from_numpy(bt_row), torch.from_numpy(tokens), base, clen,
        kernel=kernels[1])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
    for k in "kv":
        np.testing.assert_allclose(tpool[k][:, :PAGES].numpy(),
                                   np.asarray(jpool[k])[:, :PAGES], **KV_TOL)


def test_write_chunk_and_append_against_reference():
    """The in-place scatters write what the reference's functional
    updates produce, and leave every other position as it was."""
    rng = np.random.default_rng(6)
    N, Hkv, bs, D, nb = 9, 2, 4, 8, 5
    pk, pv = (rng.standard_normal((N, Hkv, bs, D)).astype(np.float32)
              for _ in range(2))
    k_new, v_new = (rng.standard_normal((1, Hkv, 8, D)).astype(np.float32)
                    for _ in range(2))
    bt_row = np.array([3, 0, 7, 8, 8], np.int32)      # 8 = trash
    want = jkv.write_chunk_paged_layer(*map(jnp.asarray, (pk, pv, k_new, v_new,
                                                          bt_row)),
                                       jnp.int32(2), jnp.int32(7))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tkv.write_chunk_paged_layer(tk, tv, torch.from_numpy(k_new),
                                torch.from_numpy(v_new), torch.from_numpy(bt_row),
                                2, 7)
    np.testing.assert_array_equal(tk[:8].numpy(), np.asarray(want[0])[:8])
    np.testing.assert_array_equal(tv[:8].numpy(), np.asarray(want[1])[:8])

    bt = np.array([[1, 2, 3, 4, 5], [6, 7, 0, 8, 8]], np.int32)
    length = np.array([9, 6], np.int32)
    live = np.array([1, 1], np.int32)
    k1, v1 = (rng.standard_normal((2, Hkv, 1, D)).astype(np.float32)
              for _ in range(2))
    want = jkv.append_token_paged(*map(jnp.asarray, (pk, pv, k1, v1, bt, length,
                                                     live)), 8)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tkv.append_token_paged(tk, tv, *map(torch.from_numpy, (k1, v1, bt, length,
                                                           live)), 8)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want[1]))


def test_copy_page_against_reference():
    rng = np.random.default_rng(7)
    pool = {k: rng.standard_normal((2, 5, 2, 4, 8)).astype(np.float32) for k in "kv"}
    want = jkv.copy_page({k: jnp.asarray(v) for k, v in pool.items()},
                         jnp.int32(1), jnp.int32(3))
    got = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    tkv.copy_page(got, 1, 3)
    for k in "kv":
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_other_families_not_ported():
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), family="moe")
    assert tmodel.supports_slot_serving(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.init_params(cfg, torch.Generator("cpu"))
