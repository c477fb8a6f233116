"""The recurrent and encoder-decoder families split over the model axis: the
port's ranks against ``repro``'s single-device steps, on the CPU.

One process a rank over ``gloo`` (``spawn_ranks``; what a rank runs is
``tests/torch_recurrent_mesh_ranks.py``, which imports no JAX), one spawn
per mesh shape running all of that shape's cases (the three at once,
beside the JAX references), each rank starting from
the WHOLE parameters converted from the reference's ``init_params``
(whisper-base's biases given random values, so the split bias paths carry
numbers).  Reduced rwkv6-7b (4 time-mix heads, d_ff 256), zamba2-1.2b (8
Mamba2 heads, 4/2 attention heads) and whisper-base (4/2 heads), f32, at
(1, 2), (2, 2) and (1, 4); at (1, 4) the ranks of zamba2's and whisper's
attention hold shared KV heads (``KV_GROUP``):

* 3 AdamW steps on a global batch of 4 x 32 tokens (whisper: and 24
  seeded frames a row): the losses, grad norms and the re-gathered params,
  ``m`` and ``v`` equal the JAX ``make_train_step`` on one device; also
  zamba2 with fsdp at (2, 2), and with ``compress_grads`` at (1, 2) (its
  losses and grad norms: a gradient on an int8 rounding boundary may round
  to the other neighbour, moving a few elements of the state by a step);
* each rank's completed gradient of the first batch is the whole
  gradient's slice, Mamba2's B/C columns (held by every rank) included;
* replicated leaves are bit-identical across the model ranks, every leaf
  across data ranks;
* lockstep serving under a rank's scope: ``model.init_cache`` at the
  shard's config is the whole cache's slice (RWKV6 ``S`` and Mamba2 ``h``
  by heads, Mamba2 ``conv``'s x channels with B/C whole, the KV by heads);
  ``prefill`` gives the JAX ``prefill``'s last logits and cache, and 4
  ``decode_step``s from the reference's prefill cache (its K/V held in
  f32) its logits and greedy tokens;
* error feedback of zamba2's split leaves (``Runs``: several ranges of the
  whole leaf) in the whole leaf's blocks equals the reference's;
* a rank's shard put back together is the whole tree; a rank's
  seed-drawn parameters are its slice of the whole draw; the gradient
  layout's partial leaves; ``launch.train --mesh 1,2`` trains rwkv6 and
  zamba2 and still refuses whisper.

Tolerances as ``tests/test_torch_train_mesh.py``'s: 1e-5 for losses, grad
norms, gradients, ``m``, ``v`` and logits (f32 sums in another order and
over other ranks), parameters within 5e-5 absolute (AdamW divides an
element's gradient by its own size); a bf16 cache leaf within one bf16
step where the rank held its K/V in f32.
"""

import functools
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_recurrent_mesh_ranks as ranks  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.group import spawn_ranks  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import schedule  # noqa: E402
from repro_torch.runtime.train_loop import MeshShard  # noqa: E402

torch.set_num_threads(1)
RWKV, ZAMBA, WHISPER = ranks.RWKV, ranks.ZAMBA, ranks.WHISPER
FAMILIES = (RWKV, ZAMBA, WHISPER)
SHAPES = [(1, 2), (2, 2), (1, 4)]
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 5e-5
BF16_STEP = dict(rtol=2 ** -7, atol=2 ** -7)
TIMEOUT_S = 240.0
CPU = ["cpu"]
# lockstep: 2 rows of a 16-token prompt (a multiple of both scans' chunks),
# then 4 decode steps, in a cache of 32
PROMPT, DECODE, MAX_LEN = 16, 4, 32

# (shape, case name, arch, loop overrides, fsdp, reference name)
TRAIN_CASES = [(s, a, a, {}, False, a) for s in SHAPES for a in FAMILIES] + [
    ((2, 2), "zamba-fsdp", ZAMBA, {}, True, ZAMBA),
    ((1, 2), "zamba-compress", ZAMBA, {"compress_grads": True}, False, "zamba-compress"),
]
REFS = {RWKV: (RWKV, {}), ZAMBA: (ZAMBA, {}), WHISPER: (WHISPER, {}),
        "zamba-compress": (ZAMBA, {"compress_grads": True})}
LRS = [schedule.warmup_cosine(s, peak_lr=3e-4, warmup_steps=1, total_steps=ranks.STEPS)
       for s in range(ranks.STEPS)]
CASE_IDS = [f"{s[0]}x{s[1]}-{a}" for s in SHAPES for a in FAMILIES]
CASES = [(s, a) for s in SHAPES for a in FAMILIES]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}[{k!r}]")
    else:
        yield path, tree


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    cfg = ARCHS[arch].reduced()
    p = jax.jit(lambda k: jmodel.init_params(cfg, k))(jax.random.PRNGKey(0))
    if cfg.family == "encdec":
        # zero-initialised biases: give the split bias paths real values
        rng = np.random.default_rng(1)
        for stack in ("encoder", "decoder"):
            p[stack] = {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
                            if "_b" in k else v) for k, v in p[stack].items()}
    return p


def port_params(arch):
    return params_from_jax(jax.tree.map(np.asarray, jax_params(arch)), device="cpu")


def batch_at(arch, step):
    return ranks.stream_for(ranks.reduced(arch)).batch_at(step)


def jax_run(arch, loop_kw):
    """3 steps of the reference's train step on one device: the metrics
    and {key: numpy} of the params, m and v."""
    cfg = ARCHS[arch].reduced()
    opt_cfg = jadamw.AdamWConfig()
    compress = loop_kw.get("compress_grads", False)
    step = jax.jit(jtrain.make_train_step(cfg, opt_cfg, compress_grads=compress))
    params = jax_params(arch)
    opt = jtrain.init_opt_state(opt_cfg, params, compress_grads=compress)
    metrics = []
    for s in range(ranks.STEPS):
        params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, batch_at(arch, s)),
                              LRS[s])
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    state = {"params": params, "m": opt["m"], "v": opt["v"]}
    return metrics, {k: np.asarray(v) for k, v in _flat(jax.tree.map(np.asarray, state))}


def jax_grads(arch):
    cfg = ARCHS[arch].reduced()
    batch = jax.tree.map(jnp.asarray, batch_at(arch, 0))
    g = jax.grad(lambda p: jmodel.loss_fn(cfg, p, batch))(jax_params(arch))
    return {k: np.asarray(v) for k, v in _flat(jax.tree.map(np.asarray, g))}


def lockstep_inputs(arch):
    """The prompt batch, the decode tokens, and the reference's prefill and
    decode: its last logits, caches (numpy) and each step's logits."""
    cfg = ARCHS[arch].reduced()
    full = batch_at(arch, 0)
    batch = {"tokens": full["tokens"][:2, :PROMPT]}
    if "frames" in full:
        batch["frames"] = full["frames"][:2]
    steps = full["tokens"][:2, PROMPT:PROMPT + DECODE]
    jp = jax_params(arch)
    init = jmodel.init_cache(cfg, 2, MAX_LEN)
    prefill = jax.jit(lambda p, b, c: jmodel.prefill(cfg, p, b, c))
    cache, logits = prefill(jp, jax.tree.map(jnp.asarray, batch), init)
    prefill_cache = cache
    # the decode steps start from the reference's cache with its K/V in f32
    cache = {k: (v.astype(jnp.float32) if k in ("k", "v") else v) for k, v in cache.items()}
    start = params_from_jax(jax.tree.map(np.asarray, cache), device="cpu")
    decode = jax.jit(lambda c, t: jmodel.decode_step(cfg, jp, c, t))
    step_logits = []
    for i in range(DECODE):
        cache, lg = decode(cache, jnp.asarray(steps[:, i:i + 1]))
        step_logits.append(np.asarray(lg))
    as_np = lambda c: {k: np.asarray(v, np.float32) for k, v in _flat(  # noqa: E731
        jax.tree.map(np.asarray, c))}
    dtypes = {k: np.asarray(v).dtype.name for k, v in _flat(jax.tree.map(np.asarray, init))}
    return dict(batch=batch, steps=steps, start=start, prefill=np.asarray(logits),
                prefill_cache=as_np(prefill_cache), decode=step_logits,
                decode_cache=as_np(cache), init=as_np(init), init_dtypes=dtypes,
                prefill_dtypes={k: np.asarray(v).dtype.name for k, v in _flat(
                    jax.tree.map(np.asarray, prefill_cache))})


def cases_for(shape, params, locks, ef):
    out = []
    for s, name, arch, loop, fsdp, _ in TRAIN_CASES:
        if s == shape:
            out.append(dict(kind="train", name=name, arch=arch, loop=loop, fsdp=fsdp,
                            params=params[arch]))
    for arch in FAMILIES:
        lk = locks[arch]
        out.append(dict(kind="lockstep", name=f"lockstep-{arch}", arch=arch,
                        params=params[arch], batch=lk["batch"], steps=lk["steps"],
                        cache=lk["start"], max_len=MAX_LEN))
    if shape == (1, 2):
        out.append(dict(kind="ef", name="ef", arch=ZAMBA, grads=ef[0], residual=ef[1]))
    return out


def ef_inputs():
    """Whole gradient and residual trees of reduced zamba2-1.2b's shapes."""
    rng = np.random.default_rng(5)
    shapes = {k: tuple(v.shape) for k, v in _flat(jax_params(ZAMBA))}
    tree = port_params(ZAMBA)
    g = sharding.map_leaves(tree, lambda k, _: rng.standard_normal(shapes[k]).astype(np.float32))
    e = sharding.map_leaves(tree, lambda k, _: (0.01 * rng.standard_normal(shapes[k])
                                                ).astype(np.float32))
    return g, e


def spawn_one(shape, params, locks, ef):
    return spawn_ranks(ranks.mesh_cases, CPU * (shape[0] * shape[1]),
                       (shape, cases_for(shape, params, locks, ef)), timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def world():
    """The ranks' results (spawned in a thread) and the JAX references
    (computed meanwhile in this process)."""
    params = {a: port_params(a) for a in FAMILIES}
    locks = {a: lockstep_inputs(a) for a in FAMILIES}
    ef = ef_inputs()
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        futs = {s: pool.submit(spawn_one, s, params, locks, ef) for s in SHAPES}
        refs = {name: jax_run(arch, kw) for name, (arch, kw) in REFS.items()}
        grads = {a: jax_grads(a) for a in FAMILIES}
        ef_ref = jcomp.ErrorFeedback.apply(jax.tree.map(jnp.asarray, ef[0]),
                                           jax.tree.map(jnp.asarray, ef[1]))
        runs = {s: f.result() for s, f in futs.items()}
    return dict(runs=runs, refs=refs, grads=grads, locks=locks, ef_ref=ef_ref)


def assert_metrics(got, want):
    assert len(got) == len(want)
    for (l, g), (wl, wg) in zip(got, want):
        assert l == pytest.approx(wl, rel=TOL["rtol"], abs=TOL["atol"])
        assert g == pytest.approx(wg, rel=TOL["rtol"], abs=TOL["atol"])


@pytest.mark.parametrize("shape,name,arch,loop,fsdp,ref", TRAIN_CASES,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n, *_ in TRAIN_CASES])
def test_mesh_matches_jax_single_device(world, shape, name, arch, loop, fsdp, ref):
    res = world["runs"][shape][0][name]
    want_metrics, want_state = world["refs"][ref]
    assert_metrics(res["metrics"], want_metrics)
    if loop.get("compress_grads"):
        # a gradient value on an int8 rounding boundary (the sums run in
        # another order) may round to either neighbour: a few elements of
        # the state then part by a quantizer step; the split leaves' error
        # feedback is held to 1e-6 on its own
        # (test_split_error_feedback_uses_the_whole_leaves_blocks)
        return
    for key, w in want_state.items():
        g = res["whole"][key]
        assert g.shape == w.shape, key
        atol = PARAM_ATOL if key.startswith("['params']") else TOL["atol"]
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=atol, err_msg=key)


@pytest.mark.parametrize("shape,arch", CASES, ids=CASE_IDS)
def test_each_rank_gradient_is_the_whole_gradients_slice(world, shape, arch):
    """The completed gradient of the first batch on every rank: its slice of
    the single-device gradient, leaf by leaf (a missing sum leaves a
    partial, a doubled one twice the value: the time-mix's entry, the mixes
    and decay LoRA input read before the split heads, Mamba2's B/C ranges,
    the whole-row norms' backward)."""
    cfg = ranks.reduced(arch)
    plan = sharding.shard_plan(cfg, shape[1])
    for rank, res in enumerate(world["runs"][shape]):
        m = rank % shape[1]
        for key, want in world["grads"][arch].items():
            cuts = sharding.rank_cuts(cfg, plan, m, 0, 1, key, want.shape)
            want_r = sharding.cut_leaf(torch.tensor(want), cuts).numpy()
            np.testing.assert_allclose(res[arch]["grads"][key], want_r,
                                       err_msg=f"rank {rank} {key}", **TOL)


@pytest.mark.parametrize("shape,arch", CASES, ids=CASE_IDS)
def test_replicas_stay_bit_identical(world, shape, arch):
    """After the steps: a leaf no rank splits is the same bits on every
    rank, and every leaf on every data rank of one model index."""
    dp, mp = shape
    cfg = ranks.reduced(arch)
    res = [r[arch]["digests"] for r in world["runs"][shape]]
    for key in res[0]:
        if not sharding.splits_leaf(cfg, mp, key):
            assert len({d[key] for d in res}) == 1, key
        for m in range(mp):
            assert len({res[d * mp + m][key] for d in range(dp)}) == 1, key


def _cut_np(cfg, mp, m, key, arr):
    cut = ranks.cache_cut(cfg, mp, m, key, arr.shape) if arr.ndim else None
    return arr if cut is None else sharding.narrow(torch.tensor(arr), cut).numpy()


@pytest.mark.parametrize("shape,arch", CASES, ids=CASE_IDS)
def test_lockstep_matches_jax(world, shape, arch):
    """A rank's lockstep cache at its shard's config, its prefill and its
    decode steps against the reference's (module docstring)."""
    cfg, lk = ranks.reduced(arch), world["locks"][arch]
    mp = shape[1]
    for rank, res in enumerate(world["runs"][shape]):
        got = res[f"lockstep-{arch}"]
        m = rank % mp
        for key, arr in lk["init"].items():
            want = _cut_np(cfg, mp, m, key, arr)
            assert got["init"][key] == (want.shape, lk["init_dtypes"][key]), (rank, key)
        np.testing.assert_allclose(got["prefill"], lk["prefill"], err_msg=f"rank {rank}",
                                   **TOL)
        for key, arr in lk["prefill_cache"].items():
            tol = BF16_STEP if lk["prefill_dtypes"][key] == "bfloat16" else TOL
            np.testing.assert_allclose(got["prefill_cache"][key],
                                       _cut_np(cfg, mp, m, key, arr),
                                       err_msg=f"rank {rank} prefill {key}", **tol)
        for i, (g, w) in enumerate(zip(got["decode"], lk["decode"])):
            np.testing.assert_allclose(g, w, err_msg=f"rank {rank} step {i}", **TOL)
            assert (g.argmax(-1) == w.argmax(-1)).all(), (rank, i)
        for key, arr in lk["decode_cache"].items():
            np.testing.assert_allclose(got["decode_cache"][key],
                                       _cut_np(cfg, mp, m, key, arr),
                                       err_msg=f"rank {rank} decode {key}", **TOL)


def test_split_error_feedback_uses_the_whole_leaves_blocks(world):
    """Reduced zamba2-1.2b at (1, 2): a rank's ``m_in_proj`` is 292 of each
    552-wide row (its z, x, dt columns and the B/C every rank holds), no run
    of 256; the EF of every rank's slices, gathered, is the reference's on
    the whole leaves."""
    comp, res = world["ef_ref"]
    for r in (0, 1):
        got = world["runs"][(1, 2)][r]["ef"]
        for name, want in (("comp", comp), ("res", res)):
            for key, w in _flat(jax.tree.map(np.asarray, want)):
                np.testing.assert_allclose(got[name][key], w, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name} {key}")


SPLITS = [(a, mp) for a in FAMILIES for mp in (2, 4)]


@pytest.mark.parametrize("arch,mp", SPLITS, ids=[f"{a}-{mp}" for a, mp in SPLITS])
def test_reshard_then_unshard_gives_the_whole_tree(arch, mp):
    """Each rank's shard (``MeshShard.shard``) put back together leaf by
    leaf (``unshard_leaf``, as a checkpoint gathers it) is the whole tree:
    Mamba2's runs placed back, shared B/C and ``KV_GROUP`` slices the
    same on every rank that holds them."""
    cfg = ranks.reduced(arch)
    whole = port_params(arch)
    shards = [MeshShard(cfg, specs.counting_groups(2, mp, r)).shard(whole)
              for r in range(2 * mp)]
    for key, leaf in sharding._walk(whole):
        parts = [dict(sharding._walk(s))[key] for s in shards[mp:]]   # data rank 1
        assert torch.equal(sharding.unshard_leaf(cfg, mp, key, parts), leaf), key


@pytest.mark.parametrize("arch,mp", SPLITS, ids=[f"{a}-{mp}" for a, mp in SPLITS])
def test_a_rank_draws_only_its_slice(arch, mp):
    """A mesh rank's seed-drawn parameters (each leaf cut to the rank's
    slice as it is drawn, ``MeshShard.keep``, before the next layer is
    drawn) are the rank's shard of the whole parameters drawn from the same
    seed."""
    cfg = ranks.reduced(arch)
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
        assert sum(t.numel() for t in got.values()) < sum(
            t.numel() for _, t in sharding._walk(whole))


def test_grad_layout_rules():
    """RWKV6's mixes and decay LoRA input get partials (read before the
    split heads), its channel-mix receptance stays whole; Mamba2's
    ``m_in_proj`` is several ranges with B/C shared; whisper's cross
    attention splits by head and ``mlp_b_out`` stays whole."""
    def lay(arch, mp, r):
        cfg = ranks.reduced(arch)
        return dict(sharding._walk(sharding.grad_layout(cfg, mp, r,
                                                        tmodel.param_shapes(cfg))))
    r6 = lay(RWKV, 2, 1)
    for name in ("mix_r", "mix_w", "w_lora_a"):
        assert r6[f"['layers']['{name}']"].partial == "model", name
    assert r6["['layers']['cr']"].cut is None and r6["['layers']['cr']"].partial is None
    assert r6["['layers']['wo']"].cut == (1, 64, 64)
    assert r6["['layers']['ck']"].cut == (2, 128, 128)
    z = lay(ZAMBA, 2, 1)["['macro']['m_in_proj']"]
    # [z 128 | x 128 | B C 32 | dt 4] of the whole [256 | 256 | 32 | 8]
    assert isinstance(z.cut, sharding.Runs) and z.cut.runs == (
        (128, 128), (384, 128), (512, 32), (548, 4))
    assert z.shared == (3, ((256, 32),)) and z.partial is None
    w = lay(WHISPER, 2, 0)
    assert w["['decoder']['xattn_wk']"].cut == (2, 0, 32)   # 1 of 2 KV heads
    assert w["['decoder']['mlp_b_out']"].cut is None
    assert w["['decoder']['ln_x']"].cut is None


@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_launcher_trains_the_family_at_mp2(arch, capsys):
    tlaunch.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                  "--seq", "16", "--mesh", "1,2", "--device", "cpu", "--no-vpe"])
    assert "done: 2 steps [mesh 1x2]" in capsys.readouterr().out


def test_launcher_still_refuses_whisper_on_a_mesh(capsys):
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", WHISPER, "--smoke", "--mesh", "1,2", "--device", "cpu"])
    assert "frames" in capsys.readouterr().err


def test_continuous_engine_keeps_refusing_the_families():
    """The continuous engine serves the transformer families only, on a
    mesh as on one device, with the reference's message."""
    from repro_torch.runtime.serve_loop import make_serve_engine
    for arch in FAMILIES:
        cfg = ranks.reduced(arch)
        with pytest.raises(ValueError, match="has no slot-serving path"):
            make_serve_engine(cfg, None, device="cpu")


def test_checkpoint_of_a_split_tree_restores_whole(tmp_path):
    """A checkpoint of the whole tree restores a rank's shard of Mamba2's
    several-range leaves (``ckpt.restore`` with the rank's cuts)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    cfg = ranks.reduced(ZAMBA)
    whole = port_params(ZAMBA)
    ckpt.save(str(tmp_path), 1, {"params": whole})
    for r in range(2):
        shard = MeshShard(cfg, specs.counting_groups(1, 2, r))
        like = shard.shard({"params": whole})
        like = sharding.map_leaves(like, lambda _, t: torch.zeros_like(t))
        ckpt.restore(str(tmp_path), like, cut=shard.cuts)
        want = shard.shard({"params": whole})
        for key, t in sharding._walk(like):
            assert torch.equal(t, dict(sharding._walk(want))[key]), (r, key)

