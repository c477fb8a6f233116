"""Training on a ``(data, model)`` mesh of the port against ``repro``'s
single-device train step, on the CPU.

One process a rank over ``gloo`` (``spawn_ranks``; what a rank runs is
``tests/torch_train_mesh_ranks.py``, which imports no JAX), one spawn per
mesh shape running all of that shape's cases, each rank building its
``TrainLoop`` with the WHOLE parameters converted from the reference's
``init_params`` and keeping its shard.  Reduced f32 configs, 3 steps of a
global batch of 4 x 32 tokens:

* qwen3-8b at (2, 1), (1, 2), (2, 2) and (1, 4) (the last with
  ``KV_GROUP``: Hkv = 2 over 4 ranks), qwen2-7b (QKV bias) at (1, 2),
  qwen2-moe-a2.7b at (2, 1) and (1, 2), zamba2-1.2b at (2, 1),
  ``remat="none"`` beside the configs' ``"full"`` at (1, 2),
  ``num_microbatches=2`` at (2, 1) and ``compress_grads`` at (1, 2) and
  (2, 2): the losses, grad norms and the re-gathered params, ``m`` and
  ``v`` equal the JAX ``make_train_step`` on one device, and qwen3-8b's
  equal the port's single-device ``TrainLoop``;
* each rank's completed gradient of the first batch is the single-device
  gradient's slice (the check that catches a missing or doubled sum);
* replicated leaves are bit-identical across model ranks and every leaf
  across data ranks;
* error feedback of a split leaf in the whole leaf's blocks equals the
  reference's on the whole gradient; ``compressed_psum`` at 4 ranks
  equals the reference's at 4 devices (a JAX subprocess);
* rank 0's VPE variants and watchdog verdicts are every rank's under
  skewed clocks;
* rung 2 (a fault at the same step on every rank, restored on the same
  mesh), and a (2, 2) checkpoint restored at (2, 1), at one device and at
  (1, 2) after rung 3's re-spawn on ``best_mesh`` of 2 survivors, each
  continuing with the uninterrupted run's losses;
* ``best_mesh``/``shrink_plan`` against the reference's, the MoE
  group-alignment ``ValueError``, ``Prefetcher`` and the launcher.

Tolerances: f32 sums in another order and over other ranks, 1e-5
(``TOL``) for losses, grad norms, gradients, ``m`` and ``v``, and for
parameters relatively, with ``PARAM_ATOL`` (a sixth of one step's
learning rate) as their absolute part: AdamW's update m/(sqrt(v)+eps)
divides an element's gradient by its own size, so where a gradient lies
within f32 rounding of zero (8e-8 on one side, 1e-8 on the other) the
update moves by a large part of the learning rate, and the next step's
gradients of that token's row move with it (one element of 65536 in the
embedding parts by 1.6e-5 after 3 steps).  With ``compress_grads`` a
value on an int8 rounding boundary may round to either neighbour; the
error feedback itself is held to 1e-6 above.
"""

import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_train_mesh_ranks as ranks  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.distributed import elastic as jelastic  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import Prefetcher, SyntheticStream, device_put_batch  # noqa: E402
from repro_torch.distributed import elastic, sharding  # noqa: E402
from repro_torch.distributed.group import ShardGroup, spawn_ranks  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import schedule  # noqa: E402
from repro_torch.runtime.fault import respawn_elastic  # noqa: E402
from repro_torch.runtime.train_loop import MeshShard, rank_rows  # noqa: E402

torch.set_num_threads(1)
QWEN, QWEN2, MOE, ZAMBA = "qwen3-8b", "qwen2-7b", "qwen2-moe-a2.7b", "zamba2-1.2b"
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 5e-5
TIMEOUT_S = 240.0
CPU = ["cpu"]

# (shape, case name, arch, cfg overrides, loop overrides, reference name)
TRAIN_CASES = [
    ((2, 1), "qwen", QWEN, {}, {}, "qwen"),
    ((2, 1), "moe", MOE, {}, {}, "moe"),
    ((2, 1), "zamba", ZAMBA, {}, {}, "zamba"),
    ((2, 1), "microbatches", QWEN, {}, {"num_microbatches": 2}, "microbatches"),
    ((1, 2), "qwen", QWEN, {}, {}, "qwen"),
    ((1, 2), "qwen2", QWEN2, {}, {}, "qwen2"),
    ((1, 2), "moe", MOE, {}, {}, "moe"),
    ((1, 2), "remat_none", QWEN, {"remat": "none"}, {}, "qwen"),
    ((1, 2), "compress", QWEN, {}, {"compress_grads": True}, "compress"),
    ((2, 2), "qwen", QWEN, {}, {}, "qwen"),
    ((2, 2), "compress", QWEN, {}, {"compress_grads": True}, "compress"),
    ((1, 4), "qwen", QWEN, {}, {}, "qwen"),
]
REFS = {"qwen": (QWEN, {}), "moe": (MOE, {}), "zamba": (ZAMBA, {}),
        "qwen2": (QWEN2, {}), "microbatches": (QWEN, {"num_microbatches": 2}),
        "compress": (QWEN, {"compress_grads": True})}
SHAPES = [(2, 1), (1, 2), (2, 2), (1, 4)]
LRS = [schedule.warmup_cosine(s, peak_lr=3e-4, warmup_steps=1, total_steps=ranks.STEPS)
       for s in range(ranks.STEPS)]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def jax_params(arch):
    return jmodel.init_params(ARCHS[arch].reduced(), jax.random.PRNGKey(0))


def jax_run(arch, loop_kw):
    """3 steps of the reference's train step on one device: the metrics
    and {key: numpy} of the params, m and v."""
    cfg = ARCHS[arch].reduced()
    opt_cfg = jadamw.AdamWConfig()
    compress = loop_kw.get("compress_grads", False)
    step = jax.jit(jtrain.make_train_step(
        cfg, opt_cfg, num_microbatches=loop_kw.get("num_microbatches", 1),
        compress_grads=compress))
    params = jax_params(arch)
    opt = jtrain.init_opt_state(opt_cfg, params, compress_grads=compress)
    data = JStream(JDataConfig(vocab_size=cfg.vocab_size, seq_len=ranks.SEQ,
                               global_batch=ranks.BATCH, seed=ranks.DATA_SEED))
    metrics = []
    for s in range(ranks.STEPS):
        params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, data.batch_at(s)),
                              LRS[s])
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    state = {"params": params, "m": opt["m"], "v": opt["v"]}
    return metrics, {k: np.asarray(v) for k, v in _flat(jax.tree.map(np.asarray, state))}


def jax_grads(arch):
    cfg = ARCHS[arch].reduced()
    data = JStream(JDataConfig(vocab_size=cfg.vocab_size, seq_len=ranks.SEQ,
                               global_batch=ranks.BATCH, seed=ranks.DATA_SEED))
    batch = jax.tree.map(jnp.asarray, data.batch_at(0))
    g = jax.grad(lambda p: jmodel.loss_fn(cfg, p, batch))(jax_params(arch))
    return {k: np.asarray(v) for k, v in _flat(jax.tree.map(np.asarray, g))}


def port_params(arch):
    return params_from_jax(jax.tree.map(np.asarray, jax_params(arch)), device="cpu")


def cases_for(shape, params, ckpt):
    """Every rank-side case of one mesh shape."""
    out = []
    for s, name, arch, cfg, loop, _ in TRAIN_CASES:
        if s == shape:
            out.append(dict(kind="train", name=name, arch=arch, cfg=cfg, loop=loop,
                            params=params[arch], grads=name == "qwen"))
    if shape == (2, 2):
        out.append(dict(kind="train", name="ckpt", arch=QWEN, params=params[QWEN],
                        ckpt=ckpt))
    elif shape in ((1, 2), (2, 1)):
        out.append(dict(kind="restore", name="restore", arch=QWEN,
                        params=params[QWEN], restore=ckpt))
    if shape == (2, 1):
        out.append(dict(kind="moe_misaligned", name="moe_misaligned", arch=MOE,
                        params=params[MOE]))
    return out


def ef_inputs():
    """Whole gradient and residual trees of reduced qwen3-8b's shapes."""
    rng = np.random.default_rng(5)
    shapes = {k: tuple(v.shape) for k, v in _flat(jax_params(QWEN))}
    tree = port_params(QWEN)
    g = sharding.map_leaves(tree, lambda k, _: rng.standard_normal(shapes[k]).astype(np.float32))
    e = sharding.map_leaves(tree, lambda k, _: (0.01 * rng.standard_normal(shapes[k])
                                                ).astype(np.float32))
    return g, e


PSUM_SHAPE = (3, 700)


def psum_inputs():
    rng = np.random.default_rng(9)
    return [rng.standard_normal(PSUM_SHAPE).astype(np.float32) * (r + 1) for r in range(4)]


def reference_psum(xs):
    """The reference's compressed_psum over 4 forced host devices, in a
    subprocess so this process keeps its single CPU device."""
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "x.npy"), np.concatenate(xs, 0))
        code = (
            "import os; os.environ['XLA_FLAGS']='--xla_force_host_platform_device_count=4';"
            "import sys, jax, numpy as np; from jax.sharding import Mesh;"
            "from repro.optim.compression import compressed_psum;"
            "x = np.load(sys.argv[1]);"
            "mesh = Mesh(np.array(jax.devices()[:4]), ('pod',));"
            "np.save(sys.argv[2], np.asarray(compressed_psum(x, mesh, 'pod')))")
        out = os.path.join(d, "y.npy")
        root = os.path.join(os.path.dirname(__file__), "..")
        res = subprocess.run([sys.executable, "-c", code, os.path.join(d, "x.npy"), out],
                             capture_output=True, text=True, timeout=240, cwd=root,
                             env={**os.environ, "PYTHONPATH": "src",
                                  "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr[-2000:]
        return np.load(out)


def spawn_all(params, ckpt, extras):
    """Every mesh's ranks, (2, 2) first (its checkpoint is the others'),
    (1, 2) as rung 3's re-spawn on best_mesh of 2 survivors."""
    out = {(2, 2): spawn_ranks(ranks.mesh_cases, CPU * 4,
                               ((2, 2), cases_for((2, 2), params, ckpt), extras),
                               timeout_s=TIMEOUT_S)}
    out[(1, 2)] = respawn_elastic(ranks.mesh_cases, CPU * 2,
                                  (cases_for((1, 2), params, ckpt),), lost=2,
                                  timeout_s=TIMEOUT_S)
    for shape in ((2, 1), (1, 4)):
        out[shape] = spawn_ranks(ranks.mesh_cases, CPU * (shape[0] * shape[1]),
                                 (shape, cases_for(shape, params, ckpt)),
                                 timeout_s=TIMEOUT_S)
    return out


@pytest.fixture(scope="module")
def world():
    """The ranks' results (spawned in a thread) and the JAX references
    (computed meanwhile in this process)."""
    params = {a: port_params(a) for a in (QWEN, QWEN2, MOE, ZAMBA)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        extras = dict(ef=ef_inputs(), psum=psum_inputs(),
                      skew=(dict(arch=QWEN, params=params[QWEN]),
                            os.path.join(tmp, "skew")))
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(spawn_all, params, ckpt, extras)
            refs = {name: jax_run(arch, kw) for name, (arch, kw) in REFS.items()}
            grads = jax_grads(QWEN)
            psum_ref = reference_psum(extras["psum"])
            ef_ref = jcomp.ErrorFeedback.apply(
                jax.tree.map(jnp.asarray, extras["ef"][0]),
                jax.tree.map(jnp.asarray, extras["ef"][1]))
            runs = fut.result()
        # the port's single-device loop, and its restore of the (2, 2)
        # checkpoint (the directory lives until here)
        single = ranks.case_loop(None, dict(arch=QWEN, params=params[QWEN]))
        single.run(ranks.STEPS)
        restored = ranks.case_loop(None, dict(arch=QWEN, params=params[QWEN]),
                                   checkpoint_dir=ckpt)
        assert restored.restore() and restored.step == 2
        restored.run(ranks.STEPS)
    return dict(runs=runs, refs=refs, grads=grads, psum_ref=psum_ref, ef_ref=ef_ref,
                ef=extras["ef"], psum=extras["psum"],
                single=(ranks._metrics(single.metrics_log), single.params),
                restored_single=ranks._metrics(restored.metrics_log))


def assert_metrics(got, want, tol=TOL):
    assert len(got) == len(want)
    for (l, g), (wl, wg) in zip(got, want):
        assert l == pytest.approx(wl, rel=tol["rtol"], abs=tol["atol"])
        assert g == pytest.approx(wg, rel=tol["rtol"], abs=tol["atol"])


def assert_state(got, want):
    """The leaves of ``want`` (params, m, v) in ``got`` (module
    docstring's tolerances)."""
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if not key.startswith("['params']"):
            np.testing.assert_allclose(g, w, err_msg=key, **TOL)
            continue
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("shape,name,arch,cfg,loop,ref",
                         TRAIN_CASES, ids=[f"{s[0]}x{s[1]}-{n}" for s, n, *_ in TRAIN_CASES])
def test_mesh_matches_jax_single_device(world, shape, name, arch, cfg, loop, ref):
    res = world["runs"][shape][0][name]
    want_metrics, want_state = world["refs"][ref]
    assert_metrics(res["metrics"], want_metrics)
    assert_state(res["whole"], want_state)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_matches_port_single_loop(world, shape):
    metrics, params = world["single"]
    res = world["runs"][shape][0]["qwen"]
    assert_metrics(res["metrics"], metrics)
    want = {f"['params']{k}": t.numpy() for k, t in sharding._walk(params)}
    assert_state(res["whole"], want)


@pytest.mark.parametrize("shape", SHAPES)
def test_each_rank_gradient_is_the_whole_gradients_slice(world, shape):
    """The completed gradient of the first batch on every rank: its slice
    of the single-device gradient, for every leaf (a missing sum leaves a
    partial, a doubled one twice the value); the same bits when the
    backward runs in another thread than the forward's scope."""
    cfg = get_config(QWEN).reduced()
    plan = sharding.shard_plan(cfg, shape[1])
    for rank, res in enumerate(world["runs"][shape]):
        m = rank % shape[1]
        for key, want in world["grads"].items():
            cut = sharding.leaf_slice(cfg, plan, m, key, want.shape) if shape[1] > 1 else None
            want_r = want if cut is None else np.take(
                want, np.arange(cut[1], cut[1] + cut[2]), axis=cut[0])
            np.testing.assert_allclose(res["qwen"]["grads"][key], want_r,
                                       err_msg=f"rank {rank} {key}", **TOL)
            # the backward (and the remat's recomputation) in a thread
            # without the rank's scope, as on a card
            np.testing.assert_array_equal(res["qwen"]["grads_elsewhere"][key],
                                          res["qwen"]["grads"][key])


@pytest.mark.parametrize("shape", SHAPES)
def test_replicas_stay_bit_identical(world, shape):
    """After the steps: a leaf no rank splits is the same bits on every
    rank, and every leaf on every data rank of one model index."""
    dp, mp = shape
    cfg = get_config(QWEN).reduced()
    res = [r["qwen"]["digests"] for r in world["runs"][shape]]
    for key in res[0]:
        if mp == 1 or not sharding.splits_leaf(cfg, mp, key):
            assert len({d[key] for d in res}) == 1, key
        for m in range(mp):
            assert len({res[d * mp + m][key] for d in range(dp)}) == 1, key


def test_split_error_feedback_uses_the_whole_leaves_blocks(world):
    """Reduced qwen3-8b's leaves at (2, 2): attn_wq's 64 columns of each
    128-wide row on a rank are not 256-aligned; the EF of every rank's
    slices, gathered, is the reference's on the whole leaves."""
    comp, res = world["ef_ref"]
    for r in (0, 1):
        got = world["runs"][(2, 2)][r]["ef"]
        for name, want in (("comp", comp), ("res", res)):
            for key, w in _flat(jax.tree.map(np.asarray, want)):
                np.testing.assert_allclose(got[name][key], w, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name} {key}")


def test_compressed_psum_matches_reference(world):
    for r in range(4):
        got = world["runs"][(2, 2)][r]["psum"]
        np.testing.assert_allclose(got, world["psum_ref"][r * PSUM_SHAPE[0]:
                                                          (r + 1) * PSUM_SHAPE[0]],
                                   rtol=1e-6, atol=1e-6)
    # and the result is the same on every rank (an all-reduce)
    np.testing.assert_array_equal(world["runs"][(2, 2)][0]["psum"],
                                  world["runs"][(2, 2)][3]["psum"])


def test_rank0_decides_under_skewed_clocks(world):
    """Rank 0's clock makes steps 5 and 6 late (two in a row: a restore);
    rank r's clock runs 1 + 2r times as fast and makes steps 3 and 8 late,
    which no rank follows; the VPE trials flash_cuda on every rank at
    once, fed the slowest rank's seconds."""
    out = [r["skew"] for r in world["runs"][(2, 2)]]
    r0 = out[0]
    assert r0["verdicts"] and len(r0["restores"]) == 1
    assert "flash_cuda" in r0["impls"] and "reference" in r0["impls"]
    for r in out[1:]:
        assert r["impls"] == r0["impls"]
        assert r["verdicts"] == r0["verdicts"] and r["restores"] == r0["restores"]
        assert r["metrics"] == r0["metrics"]
        assert r["trips"] >= 1          # its own watchdog tripped, and was not followed


def test_rung2_restores_every_rank_together(world):
    for r in world["runs"][(2, 2)]:
        assert r["ckpt"]["restores"] == 1
        assert r["ckpt"]["metrics"] == r["qwen"]["metrics"]


@pytest.mark.parametrize("where", ["1x2 (rung 3)", "2x1", "one device"])
def test_checkpoint_of_2x2_resumes_elsewhere(world, where):
    want = world["runs"][(2, 2)][0]["qwen"]["metrics"][2:]
    if where == "one device":
        got = world["restored_single"]
    else:
        shape = (1, 2) if where.startswith("1x2") else (2, 1)
        res = world["runs"][shape]
        got = res[0]["restore"]["metrics"]
        want_state = world["runs"][(2, 2)][0]["qwen"]["whole"]
        for key, w in want_state.items():
            np.testing.assert_allclose(res[0]["restore"]["whole"][key], w,
                                       err_msg=key, **TOL)
    assert_metrics(got, want)


def test_moe_groups_must_split_over_the_data_axis(world):
    for r in world["runs"][(2, 1)]:
        msg = r["moe_misaligned"]
        assert msg is not None and "moe_groups % dp == 0" in msg


def test_best_mesh_and_shrink_plan_match_reference():
    class Dev:
        def __init__(self, i):
            self.id = i
    for n in range(1, 17):
        devs = [Dev(i) for i in range(n)]
        for mp in range(1, 17):
            ref = jelastic.best_mesh(devs, model_parallel=mp)
            got = elastic.best_mesh([f"cpu:{i}" for i in range(n)], model_parallel=mp)
            assert got.shape == tuple(ref.devices.shape), (n, mp)
            assert [int(d.split(":")[1]) for d in got.devices] == \
                [d.id for d in ref.devices.reshape(-1)]
            for old in (n, 16):
                assert elastic.shrink_plan(old, n, mp) == jelastic.shrink_plan(old, n, mp)


def test_rank_rows_split_each_microbatch():
    assert rank_rows(8, 2, 1).tolist() == [4, 5, 6, 7]
    assert rank_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    assert rank_rows(6, 4, 0) is None and rank_rows(8, 1, 0) is None


def test_prefetcher_order_and_device_put():
    """tests/test_substrates.py's prefetcher check, then a rank's rows."""
    cfg = dict(vocab_size=50, seq_len=8, global_batch=2)
    from repro_torch.data import DataConfig
    src = SyntheticStream(DataConfig(**cfg))
    pf = Prefetcher(iter([src.batch_at(i) for i in range(5)]), depth=2)
    got = [b["tokens"] for b in pf]
    assert len(got) == 5
    np.testing.assert_array_equal(got[3], src.batch_at(3)["tokens"])
    b = device_put_batch(src.batch_at(0), "cpu", rows=np.array([1]))
    assert b["tokens"].shape == (1, 8) and isinstance(b["labels"], torch.Tensor)
    np.testing.assert_array_equal(b["tokens"].numpy(), src.batch_at(0)["tokens"][1:])


def test_launcher_trains_on_a_mesh(capsys):
    tlaunch.main(["--arch", QWEN, "--smoke", "--steps", "2", "--batch", "4",
                  "--seq", "16", "--mesh", "2,1", "--device", "cpu", "--no-vpe"])
    out = capsys.readouterr().out
    assert "done: 2 steps [mesh 2x1, fsdp]" in out


@pytest.mark.parametrize("arch,mp", [(QWEN, 2), (QWEN, 4), (MOE, 2)])
def test_reshard_then_unshard_gives_the_whole_tree(arch, mp):
    """Each rank's shard (``MeshShard.shard``, which ``TrainLoop`` keeps
    as it draws or restores a leaf) put back together leaf by leaf
    (``unshard_leaf``, as a checkpoint gathers it) is the whole tree,
    ``KV_GROUP`` slices taken once."""
    cfg = get_config(arch).reduced()
    whole = port_params(arch)
    shards = [MeshShard(cfg, specs.counting_groups(2, mp, r)).shard(whole)
              for r in range(2 * mp)]
    for key, leaf in sharding._walk(whole):
        parts = [dict(sharding._walk(s))[key] for s in shards[mp:]]   # data rank 1
        assert torch.equal(sharding.unshard_leaf(cfg, mp, key, parts), leaf), key


def test_grad_layout_rules():
    """Which leaves' gradients are partial on a rank: q_norm/k_norm over
    split heads, the MoE router over split experts, KV slices several
    ranks hold (each counted in the norm by its first holder)."""
    qcfg = get_config(QWEN).reduced()
    lay = lambda cfg, mp, r: dict(sharding._walk(  # noqa: E731
        sharding.grad_layout(cfg, mp, r, port_params(cfg.name.removesuffix("-smoke")))))
    two = lay(qcfg, 2, 1)
    assert two["['layers']['attn_q_norm']"].partial == "model"
    assert two["['layers']['attn_wk']"].partial is None
    assert two["['layers']['attn_wq']"].cut == (2, 64, 64) and two["['embed']"].cut is None
    four = [lay(qcfg, 4, r)["['layers']['attn_wk']"] for r in range(4)]
    assert [x.partial for x in four] == ["holders"] * 4
    assert [x.counted for x in four] == [True, False, True, False]
    moe = lay(get_config(MOE).reduced(), 2, 0)
    assert moe["['layers']['moe_router']"].partial == "model"
    assert moe["['layers']['moe_experts_gate']"].cut[0] == 1


@pytest.mark.parametrize("arch,mp", [(QWEN, 2), (QWEN, 4), (MOE, 2)])
def test_a_rank_draws_only_its_slice(arch, mp):
    """A mesh rank's seed-drawn parameters (each layer leaf cut to the
    rank's slice as it is drawn, ``MeshShard.keep``) are the rank's shard
    of the whole parameters drawn from the same seed."""
    from types import SimpleNamespace

    from repro_torch.models import model as tmodel
    cfg = get_config(arch).reduced()
    whole = tmodel.init_params(cfg, torch.Generator().manual_seed(5))
    for m in range(mp):
        shard = MeshShard(cfg, SimpleNamespace(group=None, dp=1, mp=mp, d=0, m=m,
                                               model=None))
        got = dict(sharding._walk(tmodel.init_params(
            cfg, torch.Generator().manual_seed(5), keep=shard.keep)))
        want = dict(sharding._walk(shard.shard(whole)))
        assert list(got) == list(want)
        for key, leaf in want.items():
            assert torch.equal(got[key], leaf), (m, key)


def test_checkpoint_gather_hands_the_collective_device_tensors(monkeypatch):
    """Saving on a mesh gathers each split leaf's parts on the rank's
    device, as NCCL needs (it takes no host tensors): under a stand-in
    for NCCL's all-gather, on leaves that live off the host (the meta
    device stands for the card), only device tensors reach the
    collective, and every leaf comes back whole and on the host."""
    from types import SimpleNamespace

    from repro_torch.models import model as tmodel
    from repro_torch.runtime.train_loop import TrainLoop
    cfg, mp = get_config(QWEN).reduced(), 2
    seen = []

    def nccl_all_gather(parts, part, group=None):
        for t in [part, *parts]:
            if t.device.type == "cpu":
                raise RuntimeError("NCCL: a host tensor reached the collective")
        seen.append(part.shape)

    host = torch.Tensor.cpu
    monkeypatch.setattr(torch.distributed, "all_gather", nccl_all_gather)
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t: (
        torch.zeros(t.shape, dtype=t.dtype) if t.is_meta else host(t)))
    whole = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    shard = sharding.shard_params(cfg, whole, mp, 1)[0]
    on_card = sharding.map_leaves(shard, lambda _, t: t.to("meta"))
    loop = SimpleNamespace(cfg=cfg, mesh=SimpleNamespace(
        groups=SimpleNamespace(mp=mp, model=None, d=0, group=ShardGroup(0, mp, "nccl")),
        data_cut=lambda path: None))
    got = sharding.map_leaves(on_card, lambda k, t: TrainLoop._gathered(loop, k, t))
    splits = [k for k, _ in sharding._walk(whole) if sharding.splits_leaf(cfg, mp, k)]
    assert splits and len(seen) == len(splits)
    for key, leaf in sharding._walk(whole):
        out = dict(sharding._walk(got))[key]
        assert out.device.type == "cpu" and out.shape == leaf.shape, key
