"""The serve mesh's head sharding (``mp > 1``) of the port against ``repro``.

The port's split (``repro_torch.distributed.sharding.shard_specs`` and
the shard-local page pool) against the reference's ``param_specs`` and
``serve_kv_spec`` on ``tests/test_mesh_parity.py``'s fake meshes (reduced
qwen3-8b and qwen2-moe-a2.7b at mp 2, 3, 4 and 8): equal except where
recorded (``embed`` and ``lm_head`` replicated, KV heads held whole by
the query heads that read them where the rules split inside a head or
replicate the pool).  ``shard_params``' shards concatenate
back to the whole tensors.

Then the engine, one process a rank over ``gloo`` on ``["cpu"] * mp``
(``spawn_ranks``; what a rank runs is ``tests/torch_shard_ranks.py``,
which imports no JAX): reduced f32 qwen3-8b at ``(1, 2)``, ``(1, 4)`` and
``(2, 2)`` and reduced qwen2-moe-a2.7b at ``(1, 2)`` give the JAX
unsharded engine's tokens on the contiguous, paged and ``auto`` layouts
(``test_mesh_parity.py``'s workload: 6 requests, 2 slots, max_len 48,
block 8); with both kernel variants pinned the kernels run on every
shard, at ``(1, 4)`` too, where ``Hkv = 2`` does not split and each rank
holds the one KV head its query head reads; the MoE
block split by experts and by hidden columns drops the JAX block's
assignments; with every axis on ``auto``, deadlines, and rank 1 on a
skewed clock with a tripping watchdog, every rank takes rank 0's
decisions and tokens; a submission that differs raises on every rank;
a decode fault demotes ``decode_cuda`` at the same step on both ranks.
The JAX side runs only in this process; the parent converts the JAX
parameters with ``params_from_jax`` and hands the tensors to the ranks.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_shard_ranks as ranks  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as tshard  # noqa: E402
from repro_torch.distributed.group import (ShardScope, project_out,  # noqa: E402
                                           shard_backend, shard_scope,
                                           spawn_ranks)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

torch.set_num_threads(1)
QWEN, MOE = "qwen3-8b", "qwen2-moe-a2.7b"
# a rank that waits longer than this in a collective fails the test
TIMEOUT_S = 240.0
# the MoE block: test_torch_moe.py's spec, outputs within 1e-5 (f32 sums
# in another order and over two ranks)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
# (arch, mp) -> leaves where the port's split departs from the rules
DEPARTURES = {
    (QWEN, 2): {"['embed']", "['lm_head']"},
    (QWEN, 3): set(),
    (QWEN, 4): {"['embed']", "['lm_head']", "['layers']['attn_wk']",
                "['layers']['attn_wv']"},
    (MOE, 2): {"['embed']", "['lm_head']"},
    (MOE, 3): set(),
    (MOE, 4): {"['embed']", "['lm_head']", "['layers']['attn_wk']",
               "['layers']['attn_wv']", "['layers']['attn_bk']",
               "['layers']['attn_bv']"},
}
# mp = 8 > Hq = 4: the rules split inside a head, the port replicates
# attention whole
_ATTN = {f"['layers']['attn_{w}']" for w in ("wq", "wk", "wv", "wo")}
DEPARTURES[(QWEN, 8)] = {"['embed']", "['lm_head']"} | _ATTN
DEPARTURES[(MOE, 8)] = DEPARTURES[(QWEN, 8)] | {
    f"['layers']['attn_b{w}']" for w in "qkv"}


def fake_mesh(shape):
    """``test_mesh_parity.py``'s mesh over fake devices."""
    class Dev:
        def __init__(self, i):
            self.id = i
    n = int(np.prod(shape))
    return Mesh(np.array([Dev(i) for i in range(n)], dtype=object).reshape(shape),
                ("dp", "mp"))


def _norm(spec, ndim):
    """A spec as a tuple of ndim entries (the reference's ``P()`` and a
    short tail mean None on the rest)."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def _ref_specs(arch, mp):
    cfg = ARCHS[arch].reduced()
    tree = jax.eval_shape(lambda k: jmodel.init_params(cfg, k), jax.random.PRNGKey(0))
    specs = jshard.param_specs(tree, fake_mesh((1, mp)))
    shapes = jax.tree.map(lambda a: tuple(a.shape), tree)
    return dict(_flat(shapes)), dict(_flat(specs))


@pytest.fixture(scope="module")
def setup():
    out = {}
    for arch in (QWEN, MOE):
        cfg = ARCHS[arch].reduced()
        jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        out[arch] = (cfg, get_config(arch).reduced(), jp, tp)
    return out


# -- the split against the reference's specs -----------------------------------------

SPEC_CASES = [(QWEN, 2), (QWEN, 3), (QWEN, 4), (QWEN, 8), (MOE, 2), (MOE, 3),
              (MOE, 4), (MOE, 8)]


@pytest.mark.parametrize("arch,mp", SPEC_CASES)
def test_shard_specs_depart_only_where_recorded(arch, mp):
    """What shard_params applies equals the reference's param_specs on the
    serve mesh except at the recorded departures, and every split dim
    divides."""
    shapes, ref = _ref_specs(arch, mp)
    tcfg = get_config(arch).reduced()
    port = dict(_flat(tshard.shard_specs(tcfg, tmodel.param_shapes(tcfg), mp)))
    assert port.keys() == ref.keys()
    differ = {p for p, shape in shapes.items()
              if _norm(port[p], len(shape)) != _norm(ref[p], len(shape))}
    assert differ == DEPARTURES[(arch, mp)]
    for path, shape in shapes.items():
        for dim, axis in zip(shape, port[path]):
            assert axis != tshard.MP or dim % mp == 0, (path, shape)
    if mp == 4:         # Hkv = 2: each rank holds the KV head its query head reads
        assert port["['layers']['attn_wk']"][-1] == tshard.KV_GROUP


@pytest.mark.parametrize("arch,mp", SPEC_CASES)
def test_pool_split_against_serve_kv_spec(arch, mp):
    """A rank's page pool holds the KV heads of its query heads: split as
    the reference's serve_kv_spec where Hkv divides, whole where attention
    is replicated, and (a recorded departure, where the reference
    replicates the pool) the KV group's heads where the query heads split
    and Hkv does not."""
    tcfg = get_config(arch).reduced()
    local = tshard.shard_config(tcfg, mp)
    pool = tmodel.init_page_pool(local, 3, 8, torch.device("cpu"))["k"]
    full = (tcfg.num_layers, 4, tcfg.num_kv_heads, 8, tcfg.head_dim)
    ref = _norm(jshard.serve_kv_spec(full, fake_mesh((1, mp))), 5)
    heads = pool.shape[2]
    if heads * mp == tcfg.num_kv_heads:
        assert ref[2] == "mp"
    elif heads < tcfg.num_kv_heads:
        assert ref[2] is None and tshard.shard_plan(tcfg, mp).q_heads < tcfg.num_kv_heads
        assert "['layers']['attn_wk']" in DEPARTURES[(arch, mp)]
    else:
        assert ref[2] is None and not tshard.shard_plan(tcfg, mp).attn
    assert pool.shape[2] == local.num_kv_heads
    assert local.num_heads % local.num_kv_heads == 0


@pytest.mark.parametrize("arch,mp", [(QWEN, 2), (QWEN, 4), (MOE, 2), (MOE, 4)])
def test_shards_concatenate_back(setup, arch, mp):
    """Every rank's shard, concatenated along the axis its spec splits (the
    KV group's rank-held heads deduplicated), is the whole tensor; a
    replicated leaf is the caller's tensor itself."""
    _, tcfg, _, tp = setup[arch]
    specs = tshard.shard_specs(tcfg, tp, mp)
    shards = [tshard.shard_params(tcfg, tp, mp, r) for r in range(mp)]
    plan = tshard.shard_plan(tcfg, mp)
    for name, full in tp["layers"].items():
        spec = specs["layers"][name]
        parts = [s[0]["layers"][name] for s in shards]
        if all(a is None for a in spec):
            assert all(p is full for p in parts), name
            continue
        axis = next(i for i, a in enumerate(spec) if a is not None)
        if spec[axis] == tshard.KV_GROUP:
            # mp // Hkv ranks read each KV head: one of them
            parts = parts[::mp // tcfg.num_kv_heads]
        assert torch.equal(torch.cat(parts, dim=axis), full), name
    for key in ("embed", "lm_head", "final_norm"):
        assert all(s[0][key] is tp[key] for s in shards)
    local = shards[0][1]
    assert local.vocab_size == tcfg.vocab_size
    if plan.attn:
        assert (local.num_heads, local.num_kv_heads) == (plan.q_heads, plan.kv_heads)


class _TwoRanks:
    """Rank 0 of two, in one process: the all-reduce adds rank 1's partial
    and records the dtype it was handed."""

    def __init__(self, other):
        self.other, self.summed = other, []

    def all_reduce_(self, x, group=None):
        self.summed.append(x.dtype)
        return x.add_(self.other)


@pytest.mark.parametrize("block", ["attn", "ffn"])
def test_down_projection_partials_sum_in_f32(block):
    """A bf16 down-projection split over two ranks: each rank's partial is
    computed and summed in f32 and rounded once, so the result is the
    whole f32 product rounded to bf16 (up to the f32 sum's order); without
    a scope, or for a block the plan replicates, it is ``h @ w``."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((2, 7, 256)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)).bfloat16()
    whole = (h.float() @ w.float()).bfloat16()
    group = _TwoRanks(h[..., 128:].float() @ w[128:].float())
    plan = tshard.shard_plan(get_config(QWEN).reduced(), 2)
    with shard_scope(ShardScope(group, plan)):
        got = project_out(h[..., :128], w[:128], block)
    assert group.summed == [torch.float32] and got.dtype == torch.bfloat16
    off = (got != whole).sum().item()
    assert off <= whole.numel() // 100, off
    # one bf16 step at most where the two f32 sums round apart
    torch.testing.assert_close(got.float(), whole.float(), rtol=2 ** -7, atol=0)
    # the rounding this avoids: bf16 partials part from the whole product
    # far more often
    bf16_partials = (h[..., :128] @ w[:128]).float() + (h[..., 128:] @ w[128:]).float()
    assert (bf16_partials.bfloat16() != whole).sum().item() > 4 * max(off, 1)
    assert torch.equal(project_out(h, w, block), h @ w)
    replicated = dataclasses.replace(plan, **{block: False})
    with shard_scope(ShardScope(_TwoRanks(None), replicated)):
        assert torch.equal(project_out(h, w, block), h @ w)


def test_shard_backend():
    assert shard_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert shard_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert shard_backend(["cpu", "cpu"]) == "gloo"
    assert shard_backend(["cuda", "cuda:0"]) == "gloo"


@pytest.mark.parametrize("kw", [dict(mesh_shape=(1, 2)),
                                dict(mesh_shape=(1, 4), max_queue_depth=3)])
def test_mp_without_shard_group_raises(setup, kw):
    """mp > 1 runs one process a shard: an engine built without its shard
    group raises, saying how to build one."""
    _, tcfg, _, tp = setup[QWEN]
    mp = kw["mesh_shape"][1]
    with pytest.raises(ValueError, match=f"shard_group of {mp} ranks"):
        tserve.make_serve_engine(tcfg, tp, mesh_devices=["cpu"] * mp, slots=1,
                                 max_len=48, **kw)
    with pytest.raises(ValueError, match=f"shard_group of {mp} ranks"):
        tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu", slots=1,
                                        max_len=48, **kw)


# -- the engine, one process a rank ---------------------------------------------------

_JAX_TOKENS = {}


def jax_tokens(setup, arch, layout):
    """The JAX unsharded engine's tokens on the workload."""
    if (arch, layout) not in _JAX_TOKENS:
        cfg, _, jp, _ = setup[arch]
        eng = jserve.ContinuousBatchingEngine(cfg, jp, kv_layout=layout,
                                              **ranks.ENGINE_KW)
        for r in ranks.workload(cfg.vocab_size):
            eng.submit(jserve.Request(rid=r.rid, prompt=r.prompt,
                                      max_new_tokens=r.max_new_tokens))
        _JAX_TOKENS[(arch, layout)] = {r.rid: [int(t) for t in r.out]
                                       for r in eng.run()}
    return _JAX_TOKENS[(arch, layout)]


def _block_case(num_experts, seed):
    """The MoE block's JAX parameters and input, at a capacity factor that
    drops assignments, and the JAX block's output and kept set."""
    cfg = ranks.moe_block_cfg(num_experts)
    js = jmoe.MoESpec(d_model=cfg.d_model, num_experts=num_experts,
                      top_k=cfg.top_k, moe_d_ff=cfg.moe_d_ff,
                      num_shared_experts=cfg.num_shared_experts,
                      capacity_factor=cfg.capacity_factor)
    p = jmoe.init_moe(jax.random.PRNGKey(seed), js, jnp.float32)
    x = np.random.default_rng(seed).standard_normal((4, 64, js.d_model)).astype(np.float32)
    want = np.asarray(jmoe.moe_block(p, js, jnp.asarray(x), groups=4))
    _, experts = jmoe.route(js, p["router"], jnp.asarray(x).reshape(-1, js.d_model))
    experts = experts.reshape(4, -1)
    onehot = jax.nn.one_hot(experts, js.num_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - 1, experts[..., None],
                              axis=2)[..., 0]
    keep = np.asarray(pos < jmoe.capacity(js, 64))
    tp = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    return (num_experts, tp, x, 4), want, keep


_RUNS = {}


def run(setup, name):
    """Each spawn once per module: its per-rank results."""
    if name not in _RUNS:
        qp, mp_ = setup[QWEN][3], setup[MOE][3]
        if name == "mp2":
            block, want, keep = _block_case(8, 0)
            out = spawn_ranks(ranks.mp2, ["cpu"] * 2, (qp, mp_, block),
                              timeout_s=TIMEOUT_S)
        elif name == "mp4":
            block, want, keep = _block_case(6, 1)
            out = spawn_ranks(ranks.mp4, ["cpu"] * 4, (qp, block), timeout_s=TIMEOUT_S)
        elif name == "dp2mp2":
            want = keep = None
            out = spawn_ranks(ranks.dp2mp2, ["cpu"] * 2, (qp,), timeout_s=TIMEOUT_S)
        else:
            want = keep = None
            out = spawn_ranks(ranks.agreement, ["cpu"] * 2, (qp,), timeout_s=TIMEOUT_S)
        _RUNS[name] = (out, want, keep)
    return _RUNS[name]


MESH_RUNS = {(1, 2): "mp2", (1, 4): "mp4", (2, 2): "dp2mp2"}


@pytest.mark.parametrize("layout", ranks.LAYOUTS)
@pytest.mark.parametrize("mesh", list(MESH_RUNS), ids=lambda m: f"{m[0]}x{m[1]}")
def test_engine_tokens_equal_jax_unsharded(setup, mesh, layout):
    """Reduced f32 qwen3-8b on the mesh: every rank's tokens are the JAX
    unsharded engine's, and no rank's own tokens differed from rank 0's."""
    out, _, _ = run(setup, MESH_RUNS[mesh])
    want = jax_tokens(setup, QWEN, layout)
    for rank, res in enumerate(out):
        assert res["qwen"][layout] == want, (rank, layout)
        assert res["qwen"]["mismatch"] == 0


@pytest.mark.parametrize("mesh", list(MESH_RUNS), ids=lambda m: f"{m[0]}x{m[1]}")
def test_pinned_kernels_follow_the_shard_contract(setup, mesh):
    """Both kernel variants pinned, chunked prefill, horizons of 4: the
    kernels run on every shard at its own head counts, where Hkv splits
    (mp = 2: one KV head a rank) and where it does not (mp = 4, Hkv = 2:
    each rank holds the one KV head its query head reads, G = 1); the
    tokens are the JAX engine's.  At (2, 2) both replicas serve."""
    out, _, _ = run(setup, MESH_RUNS[mesh])
    want = jax_tokens(setup, QWEN, "paged")
    mp = mesh[1]
    for res in out:
        q = res["qwen"]
        assert q["pinned"] == want
        decode, prefill = q["kernel_calls"]
        assert q["resolved"] == ("cuda", "cuda")
        assert decode > 0 and prefill > 0
        assert q["heads"] == ((2, 1) if mp == 2 else (1, 1))
        assert q["pool_heads"] == 1
        assert all(n > 0 for n in q["replica_completed"])
        assert len(q["replica_completed"]) == mesh[0]


@pytest.mark.parametrize("layout", ranks.LAYOUTS)
def test_moe_engine_tokens_equal_jax_unsharded(setup, layout):
    """Reduced qwen2-moe-a2.7b at (1, 2), its 16 padded experts split 8 a
    rank: the JAX unsharded engine's tokens on every layout."""
    out, _, _ = run(setup, "mp2")
    want = jax_tokens(setup, MOE, layout)
    for res in out:
        assert res["moe"][layout] == want
        assert res["moe"]["mismatch"] == 0
        assert res["moe"]["pinned"] == jax_tokens(setup, MOE, "paged")


@pytest.mark.parametrize("name,mode", [("mp2", "experts"), ("mp4", "columns")])
def test_moe_block_split_drops_as_jax(setup, name, mode):
    """The MoE block at a capacity factor of 0.25 (assignments drop), split
    by experts over 2 ranks (8 experts, 4 a rank) and by hidden columns
    over 4 (6 experts do not split 4 ways; 16 columns do): every rank's
    output is the JAX block's, so the ranks drop the JAX block's
    assignments."""
    out, want, keep = run(setup, name)
    assert keep.sum() < keep.size                   # the case drops
    for res in out:
        assert res["block"]["mode"] == mode
        np.testing.assert_allclose(res["block"]["out"], want, **BLOCK_TOL)
    if mode == "experts":
        assert {r["block"]["experts"] for r in out} == {4}
    else:
        assert {r["block"]["hidden"] for r in out} == {4}


def test_ranks_agree_under_skewed_clocks(setup):
    """Every axis on auto, deadlines set, rank 1's clock 1000x fast with
    jitter and its watchdog tripping at every fence: every rank logs rank
    0's decisions and decode and verify calls, commits rank 0's tokens, and
    none of its own differed; nothing sheds (rank 0's clock is read);
    speculation ran; the tokens are an unsharded engine's."""
    out, _, _ = run(setup, "agree")
    r0, r1 = out
    assert r1["decisions"] == r0["decisions"] and r0["decisions"]
    assert r1["calls"] == r0["calls"]
    assert r1["tokens"] == r0["tokens"]
    assert r0["mismatch"] == r1["mismatch"] == 0
    assert r1["own_trips"] > 0 and r0["trips"] == r1["trips"] == 0
    assert r0["demotions"] == r1["demotions"] == {}
    assert r0["failed"] == r1["failed"] == {}
    assert r0["spec_calls"] > 0
    _, tcfg, _, tp = setup[QWEN]
    kw = {k: v for k, v in ranks.AGREE_KW.items()
          if k not in ("decode_impl", "prefill_kernel", "prefill_chunk",
                       "decode_horizon", "spec_draft")}
    eng = tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    assert ranks.serve(eng, ranks.agree_requests(tcfg.vocab_size)) == r0["tokens"]


def test_mismatched_submission_raises_on_every_rank(setup):
    out, _, _ = run(setup, "agree")
    for res in out:
        assert res["mismatched_submit"] is not None
        assert "differs across the 2 shard ranks" in res["mismatched_submit"]


def test_decode_fault_demotes_at_the_same_step_on_both_ranks(setup):
    """A device fault at the third decode call: both ranks demote
    ``decode_cuda`` at the same step, and the tokens equal a clean run's
    (sharded, and the JAX engine's)."""
    out, _, _ = run(setup, "agree")
    r0, r1 = out
    assert r0["fault_demotions"] == r1["fault_demotions"]
    assert [rung for rung, _ in r0["fault_demotions"]] == ["decode_cuda"]
    assert r0["fault_stats"][0] == r1["fault_stats"][0] == 1
    for res in out:
        assert res["faulted"] == res["clean"] == jax_tokens(setup, QWEN, "paged")


def test_shard_config_keeps_routing_whole(setup):
    """The shard-local config splits heads and widths and keeps the vocab,
    depth and the expert count (every rank routes over all experts)."""
    _, tcfg, _, _ = setup[MOE]
    local = tshard.shard_config(tcfg, 2)
    assert dataclasses.replace(local, num_heads=tcfg.num_heads,
                               num_kv_heads=tcfg.num_kv_heads) == tcfg
    assert (local.num_heads, local.num_kv_heads) == (2, 1)
    cols = tshard.shard_config(dataclasses.replace(tcfg, moe_pad_experts=0,
                                                   num_experts=6), 4)
    assert cols.moe_d_ff == tcfg.moe_d_ff // 4 and cols.num_experts == 6
