"""The port's MoE family against ``repro``'s, on the CPU in f32.

``route``, ``capacity``, ``moe_block`` (groups 1 and 16, padded and
unpadded experts, shared experts on and off, and a capacity factor tight
enough to drop assignments: the same dropped set) and
``aux_load_balance_loss`` on the same inputs from a numpy seed and the
same parameters (``params_from_jax``); the gradients of
``sum(moe_block ** 2)``; the converted-parameter round trip of both MoE
configs (the router stays f32 in bf16 parameters); the loss, gradients
and three ``TrainLoop`` steps of reduced qwen2-moe-a2.7b; and reduced
qwen2-moe-a2.7b and moonshot-v1-16b-a3b served by the port's engine
against the JAX engine, greedy tokens equal, on every layout, horizon and
decode backend, and under speculation; and the launchers on both MoE
configs.

Tolerances: f32 sums in another order.  The block's output within 1e-5
(worst observed 1e-6), its gradients within 1e-4, the loss within 1e-5
relative.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402

torch.set_num_threads(1)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"]


def _specs(**kw):
    base = dict(d_model=32, num_experts=8, top_k=2, moe_d_ff=16,
                num_shared_experts=2)
    js = jmoe.MoESpec(**{**base, **kw})
    ts = tmoe.MoESpec(**dataclasses.asdict(js))
    return js, ts


def _block_inputs(js, seed=0, shape=(4, 256)):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), js, jnp.float32)
    x = np.random.default_rng(seed).standard_normal((*shape, js.d_model)).astype(np.float32)
    return p, params_from_jax(jax.tree.map(np.asarray, p), device="cpu"), x


def _reference_keep(js, p, x, groups):
    """The reference's dropped set, by the lines of its ``_routed_experts``."""
    N = x.shape[0] * x.shape[1]
    if N % groups:
        groups = 1
    xg = jnp.asarray(x).reshape(groups, -1, js.d_model)
    G, n, _ = xg.shape
    _, experts = jmoe.route(js, p["router"], xg.reshape(G * n, -1))
    experts = experts.reshape(G, n * js.top_k)
    onehot = jax.nn.one_hot(experts, js.num_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - 1
    pos = jnp.take_along_axis(pos, experts[..., None], axis=2)[..., 0]
    return np.asarray(pos < jmoe.capacity(js, n)), groups


@pytest.mark.parametrize("n", [1, 4, 16, 128, 256, 4096])
@pytest.mark.parametrize("kw", [dict(), dict(num_experts=60, top_k=4),
                                dict(num_experts=64, top_k=6, capacity_factor=0.5)])
def test_capacity_equals_reference(n, kw):
    js, ts = _specs(**kw)
    assert tmoe.capacity(ts, n) == jmoe.capacity(js, n)
    assert ts.padded_experts == js.padded_experts
    assert tmoe.moe_param_shapes(ts) == jmoe.moe_param_shapes(js)


@pytest.mark.parametrize("norm", [True, False])
def test_route_equals_reference(norm):
    js, ts = _specs(norm_topk_prob=norm)
    p, tp, x = _block_inputs(js)
    xf = x.reshape(-1, js.d_model)
    jw, je = jmoe.route(js, p["router"], jnp.asarray(xf))
    tw, te = tmoe.route(ts, tp["router"], torch.from_numpy(xf))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **OUT_TOL)
    assert tw.dtype == torch.float32


@pytest.mark.parametrize("groups", [1, 16])
@pytest.mark.parametrize("pad_to", [0, 16])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_block_equals_reference(groups, pad_to, shared, capacity_factor):
    """Outputs within 1e-5, and at ``capacity_factor=0.25`` the port drops
    the reference's assignments, no more, no fewer."""
    js, ts = _specs(pad_to=pad_to, num_shared_experts=shared,
                    capacity_factor=capacity_factor)
    p, tp, x = _block_inputs(js)
    want = np.asarray(jmoe.moe_block(p, js, jnp.asarray(x), groups=groups))
    got = tmoe.moe_block(tp, ts, torch.from_numpy(x), groups=groups)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)

    keep_ref, G = _reference_keep(js, p, x, groups)
    xg = torch.from_numpy(x).reshape(G, -1, js.d_model)
    n = xg.shape[1]
    _, experts = tmoe.route(ts, tp["router"], xg.reshape(G * n, -1))
    keep, slot = tmoe.dispatch(ts, experts.reshape(G, -1), tmoe.capacity(ts, n))
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    if capacity_factor < 1:
        assert keep_ref.sum() < keep_ref.size       # the case drops
    # padded experts get no rows
    assert int(slot.max()) < ts.num_experts * tmoe.capacity(ts, n)


def test_groups_fall_back_to_one():
    """B*S = 2 * 7 rows do not split into 16 groups: one global group."""
    js, ts = _specs(capacity_factor=0.25)
    p, tp, x = _block_inputs(js, shape=(2, 7))
    want = np.asarray(jmoe.moe_block(p, js, jnp.asarray(x), groups=16))
    got = tmoe.moe_block(tp, ts, torch.from_numpy(x), groups=16).numpy()
    np.testing.assert_allclose(got, want, **OUT_TOL)
    np.testing.assert_allclose(
        got, tmoe.moe_block(tp, ts, torch.from_numpy(x), groups=1).numpy(), rtol=0, atol=0)


def test_moe_block_keeps_bf16():
    """bf16 activations: a bf16 buffer and experts, the weighted sum in
    f32, the result cast back; the router stays f32."""
    js, ts = _specs(pad_to=16)
    p, tp, x = _block_inputs(js)
    tp = {k: (v if k == "router" else v.to(torch.bfloat16)) for k, v in tp.items()}
    got = tmoe.moe_block(tp, ts, torch.from_numpy(x).to(torch.bfloat16), groups=16)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())


def test_aux_loss_equals_reference():
    js, ts = _specs(num_experts=8, top_k=2)
    p, tp, x = _block_inputs(js)
    want = float(jmoe.aux_load_balance_loss(js, p["router"], jnp.asarray(x)))
    got = float(tmoe.aux_load_balance_loss(ts, tp["router"], torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("groups,capacity_factor", [(1, 1.25), (16, 0.25)])
def test_moe_block_gradients_equal_reference(groups, capacity_factor):
    """d sum(moe_block ** 2) by every parameter and by x, within 1e-4."""
    js, ts = _specs(pad_to=16, capacity_factor=capacity_factor)
    p, tp, x = _block_inputs(js)

    def jloss(p, x):
        return jnp.sum(jmoe.moe_block(p, js, x, groups=groups) ** 2)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    loss = torch.sum(tmoe.moe_block(leaves, ts, xt, groups=groups) ** 2)
    grads = torch.autograd.grad(loss, [*leaves.values(), xt])
    for (k, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **GRAD_TOL)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_convert_roundtrip_moe(name):
    """The reference's bf16 tree (full dtype, reduced shapes) converts bit
    for bit with the router in f32; the port's own ``init_params`` has the
    same keys, shapes and dtypes."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    own = tmodel.init_params(tcfg, torch.Generator("cpu").manual_seed(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node, mine = tp, own
        for key in path:
            node, mine = node[key.key], mine[key.key]
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
        want_dtype = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert node.dtype == mine.dtype == want_dtype, path
        assert tuple(node.shape) == tuple(mine.shape) == leaf.shape, path
    assert tp["layers"]["moe_router"].dtype == torch.float32
    assert tcfg.param_count() == sum(v.numel() for v in
                                     torch.utils._pytree.tree_leaves(own))


# -- training ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_train():
    cfg = ARCHS["qwen2-moe-a2.7b"].reduced()
    tcfg = get_config("qwen2-moe-a2.7b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    return cfg, tcfg, jp, {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def test_moe_loss_and_grads_equal_reference(moe_train):
    cfg, tcfg, jp, batch = moe_train
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss_fn(
        cfg, p, jax.tree.map(jnp.asarray, batch)))(jp)
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = tmodel.loss_fn(tcfg, torch.utils._pytree.tree_unflatten(leaves, spec),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.utils._pytree.tree_unflatten(
        list(torch.autograd.grad(loss, leaves)), spec)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for path, w in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        node = grads
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(w), err_msg=str(path),
                                   **GRAD_TOL)


def test_moe_train_loop_equals_reference(moe_train):
    """Three ``TrainLoop`` steps from the same parameters on the same
    synthetic batches (VPE off): each step's loss within 1e-5 relative."""
    cfg, tcfg, jp, _ = moe_train
    data = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    kw = dict(total_steps=3, log_every=0, enable_vpe=False, watchdog=False)
    jloop = jtrain.TrainLoop(cfg, jtrain.TrainLoopConfig(**kw),
                             JStream(JDataConfig(**data)), params=jp)
    tloop = ttrain.TrainLoop(tcfg, ttrain.TrainLoopConfig(**kw),
                             SyntheticStream(DataConfig(**data)), device="cpu",
                             params=params_from_jax(jax.tree.map(np.asarray, jp),
                                                    device="cpu"))
    want = [m["loss"] for m in jloop.run()]
    got = [m["loss"] for m in tloop.run()]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- serving ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_serve(request):
    cfg = ARCHS[request.param].reduced()
    tcfg = get_config(request.param).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


def _requests(mod, vocab, new_tokens):
    """Five prompts of 5-12 tokens, the last two the first two again, so
    the n-gram proposer replays their streams and its drafts land."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, int(rng.integers(5, 13))).astype(np.int32)
               for _ in range(3)]
    prompts += [prompts[0].copy(), prompts[1].copy()]
    return [mod.Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]


def _serve(eng, mod, vocab, new_tokens):
    for r in _requests(mod, vocab, new_tokens):
        eng.submit(r)
    done = eng.run()
    eng.check_kv()
    return {r.rid: [int(t) for t in r.out] for r in done}


ENGINE = dict(slots=2, max_len=48, block_size=8, prefill_chunk=8)
# (JAX engine's backends, port's backends, shared engine arguments)
SERVE_CASES = {
    "paged-gather": (("grouped", "gather"), ("grouped", "gather"),
                     dict(kv_layout="paged")),
    "paged-kernels": (("pallas", "pallas"), ("cuda", "cuda"), dict(kv_layout="paged")),
    "contiguous": (("grouped", "gather"), ("grouped", "gather"),
                   dict(kv_layout="contiguous")),
    "auto": (("grouped", "gather"), ("cuda", "gather"), dict(kv_layout="auto")),
    "paged-H4": (("pallas", "gather"), ("cuda", "gather"),
                 dict(kv_layout="paged", decode_horizon=4)),
    "paged-H16": (("grouped", "gather"), ("grouped", "gather"),
                  dict(kv_layout="paged", decode_horizon=16)),
    "spec-S4": (("grouped", "gather"), ("grouped", "gather"),
                dict(kv_layout="paged", decode_horizon=4, spec_draft=4)),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_engine_equals_reference(moe_serve, case):
    """The port's engine gives the JAX engine's greedy tokens on the same
    requests, case by case (the reference's ``pallas`` kernels run in
    interpret mode, the port's ``cuda`` wrappers their plain versions)."""
    cfg, tcfg, jp, tp = moe_serve
    jimpl, timpl, kw = SERVE_CASES[case]
    # a pinned horizon clamps to the shortest remaining budget
    new_tokens = 20 if kw.get("decode_horizon") == 16 else 8
    jeng = jserve.ContinuousBatchingEngine(cfg, jp, decode_impl=jimpl[0],
                                           prefill_kernel=jimpl[1], **ENGINE, **kw)
    want = _serve(jeng, jserve, cfg.vocab_size, new_tokens)
    teng = tserve.ContinuousBatchingEngine(tcfg, tp, decode_impl=timpl[0],
                                           prefill_kernel=timpl[1], device="cpu",
                                           **ENGINE, **kw)
    assert _serve(teng, tserve, tcfg.vocab_size, new_tokens) == want
    st = teng.stats
    assert st.tokens_out == 5 * new_tokens
    if kw.get("decode_horizon", 1) > 1 and "spec_draft" not in kw:
        assert st.horizon_calls > 0
    if "spec_draft" in kw:
        assert st.spec_calls > 0 and st.accepted_tokens > 0
        assert (st.spec_calls, st.draft_tokens, st.accepted_tokens) == (
            jeng.stats.spec_calls, jeng.stats.draft_tokens, jeng.stats.accepted_tokens)
    if teng.pages is not None:
        assert teng.pages.drained


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", ["wave", "continuous", "train"])
def test_launchers_serve_and_train_moe(capsys, arch, mode):
    """``--arch`` takes both MoE configs: the serve launcher's wave
    scheduler and continuous engine (paged, both kernels' plain versions),
    and the train launcher, on the CPU."""
    from repro_torch.launch import serve as tserve_launch
    from repro_torch.launch import train as ttrain_launch
    if mode == "train":
        ttrain_launch.main(["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
                            "--seq", "16", "--device", "cpu"])
        assert "done: 3 steps" in capsys.readouterr().out
        return
    extra = (["--continuous", "--kv-layout", "paged", "--prefill-chunk", "8",
              "--decode-impl", "cuda", "--prefill-kernel", "cuda"]
             if mode == "continuous" else [])
    tserve_launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                        "--new-tokens", "3", "--max-len", "48", *extra])
    assert "completed 3 requests" in capsys.readouterr().out
