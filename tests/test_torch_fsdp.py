"""fsdp: training on a ``(data, model)`` mesh with the params and optimizer
state cut over ``data`` as well (``TrainLoop(..., fsdp=True)``), against
``repro``'s single-device train step, on the CPU.

One process a rank over ``gloo`` (``spawn_ranks``; the rank side is
``tests/torch_train_mesh_ranks.py``, which imports no JAX), one spawn per
mesh shape, each rank building its loop from the WHOLE parameters
converted from the reference's and keeping its slice.  Reduced f32
configs, 3 steps of a global batch of 4 x 32 tokens, ``remat="full"``
(the configs' own):

* qwen3-8b and qwen2-moe-a2.7b at (2, 1) and (2, 2), zamba2-1.2b at
  (2, 1), and ``compress_grads`` at (2, 2): losses, grad norms and the
  gathered params, ``m`` and ``v`` equal the JAX ``make_train_step`` on
  one device (tolerances of ``tests/test_torch_train_mesh.py``: 1e-5, and
  5e-5 absolute for the params after 3 AdamW steps);
* each rank's completed gradient of the first batch is its slice (model
  cut, then data cut) of the single-device gradient, and the same bits
  when the backward, with remat's recomputation and its all-gathers,
  runs in another thread than the forward's scope (as on a card);
* a rank holds the state the dry run reckons for it
  (``launch.specs.build_train``), about a dp-th of the replicated one;
* a checkpoint saved at (2, 2) with fsdp is the whole tree, equal to the
  one-device loop's, and restores onto (2, 1) with fsdp, continuing with
  the (2, 2) run's loss;
* each rank's slice as ``MeshShard(..., fsdp=True)`` keeps it, put back
  together, is the whole tree.
"""

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import test_torch_train_mesh as tm  # noqa: E402
import torch_train_mesh_ranks as ranks  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.group import spawn_ranks  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.runtime.train_loop import MeshShard  # noqa: E402

QWEN, MOE, ZAMBA = tm.QWEN, tm.MOE, tm.ZAMBA
CPU = ["cpu"]

# (shape, case name, arch, loop overrides, reference name)
CASES = [
    ((2, 1), "qwen", QWEN, {}, "qwen"),
    ((2, 1), "moe", MOE, {}, "moe"),
    ((2, 1), "zamba", ZAMBA, {}, "zamba"),
    ((2, 2), "qwen", QWEN, {}, "qwen"),
    ((2, 2), "moe", MOE, {}, "moe"),
    ((2, 2), "compress", QWEN, {"compress_grads": True}, "compress"),
]
REFS = {"qwen": (QWEN, {}), "moe": (MOE, {}), "zamba": (ZAMBA, {}),
        "compress": (QWEN, {"compress_grads": True})}


def cases_for(shape, params, ckpt_dir):
    out = [dict(kind="train", name=name, arch=arch, loop=loop, params=params[arch],
                grads=name == "qwen", fsdp=True)
           for s, name, arch, loop, _ in CASES if s == shape]
    if shape == (2, 2):
        out.append(dict(kind="train", name="ckpt", arch=QWEN, params=params[QWEN],
                        ckpt=ckpt_dir, fsdp=True))
    else:
        out.append(dict(kind="restore", name="restore", arch=QWEN, params=params[QWEN],
                        restore=ckpt_dir, fsdp=True))
    return out


def spawn_all(params, ckpt_dir):
    """(2, 2) first: its checkpoint is (2, 1)'s restore."""
    out = {}
    for shape in ((2, 2), (2, 1)):
        out[shape] = spawn_ranks(ranks.mesh_cases, CPU * (shape[0] * shape[1]),
                                 (shape, cases_for(shape, params, ckpt_dir)),
                                 timeout_s=tm.TIMEOUT_S)
    return out


def _tree_of(directory):
    """{key: numpy} of a checkpoint's params and optimizer state."""
    step = ckpt.latest_step(directory)
    d = os.path.join(directory, f"step_{step:08d}")
    import json
    with open(os.path.join(d, "manifest.json")) as f:
        items = json.load(f)["leaves"]
    return step, {it["key"]: ckpt._load(os.path.join(d, it["file"]), it).float().numpy()
                  for it in items}


@pytest.fixture(scope="module")
def world():
    params = {a: tm.port_params(a) for a in (QWEN, MOE, ZAMBA)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(spawn_all, params, ckpt_dir)
            refs = {name: tm.jax_run(arch, kw) for name, (arch, kw) in REFS.items()}
            grads = tm.jax_grads(QWEN)
            runs = fut.result()
        saved = _tree_of(ckpt_dir)
        # the one-device loop's checkpoint at the same step
        one_dir = os.path.join(tmp, "one")
        single = ranks.case_loop(None, dict(arch=QWEN, params=params[QWEN]),
                                 checkpoint_dir=one_dir)
        single.run(saved[0])
        single.save()
        one = _tree_of(one_dir)
    return dict(runs=runs, refs=refs, grads=grads, saved=saved, one=one)


@pytest.mark.parametrize("shape,name,arch,loop,ref", CASES,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n, *_ in CASES])
def test_fsdp_matches_jax_single_device(world, shape, name, arch, loop, ref):
    res = world["runs"][shape][0][name]
    want_metrics, want_state = world["refs"][ref]
    tm.assert_metrics(res["metrics"], want_metrics)
    tm.assert_state(res["whole"], want_state)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_each_rank_gradient_is_its_slice(world, shape):
    dp, mp = shape
    cfg = get_config(QWEN).reduced()
    plan = sharding.shard_plan(cfg, mp)
    for rank, res in enumerate(world["runs"][shape]):
        d, m = divmod(rank, mp)
        for key, want in world["grads"].items():
            cuts = sharding.rank_cuts(cfg, plan, m, d, dp, key, want.shape)
            want_r = want
            for dim, start, size in cuts:
                want_r = np.take(want_r, np.arange(start, start + size), axis=dim)
            np.testing.assert_allclose(res["qwen"]["grads"][key], want_r,
                                       err_msg=f"rank {rank} {key}", **tm.TOL)
            np.testing.assert_array_equal(res["qwen"]["grads_elsewhere"][key],
                                          res["qwen"]["grads"][key])


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_a_rank_holds_the_reckoned_state(world, shape):
    """Every rank's params and optimizer state: the bytes the dry run
    reckons for rank 0 (the slices are even), about a dp-th of the state
    replicated over data, counted by the storages the rank's tensors
    hold (a slice left as a view of the whole leaf would count it whole)."""
    cfg = get_config(QWEN).reduced()
    built = specs.build_train(cfg, ShapeConfig("t", "train", 32, 4),
                              specs.dry_mesh(*shape), fsdp=True, tp=True)
    replicated = specs.build_train(cfg, ShapeConfig("t", "train", 32, 4),
                                   specs.dry_mesh(*shape), fsdp=False, tp=True)
    want = specs.tree_bytes(built.state)
    assert want < 0.55 * specs.tree_bytes(replicated.state)
    for res in world["runs"][shape]:
        assert res["qwen"]["state_bytes"] == want


def test_checkpoint_of_fsdp_is_the_one_device_tree(world):
    step, saved = world["saved"]
    one_step, one = world["one"]
    assert step == one_step == 2 and set(saved) == set(one)
    for key, want in one.items():
        assert saved[key].shape == want.shape, key
        np.testing.assert_allclose(saved[key], want, rtol=tm.TOL["rtol"],
                                   atol=tm.PARAM_ATOL, err_msg=key)


def test_fsdp_checkpoint_restores_onto_2x1(world):
    """The (2, 2) checkpoint of step 2 restored at (2, 1) with fsdp: step 3
    gives the (2, 2) run's loss and state."""
    want = world["runs"][(2, 2)][0]["qwen"]
    got = world["runs"][(2, 1)][0]["restore"]
    tm.assert_metrics(got["metrics"], want["metrics"][2:])
    for key, w in want["whole"].items():
        np.testing.assert_allclose(got["whole"][key], w, err_msg=key, **tm.TOL)


@pytest.mark.parametrize("arch,shape", [(QWEN, (2, 2)), (MOE, (2, 2)), (ZAMBA, (4, 1))])
def test_reshard_fsdp_then_unshard(arch, shape):
    """Each rank's slice as ``MeshShard.shard`` keeps it with fsdp (the
    cuts ``TrainLoop`` draws and restores by), its data slices joined on
    their dim and its model parts unsharded, is the whole tree."""
    cfg = get_config(arch).reduced()
    whole = tm.port_params(arch)
    dp, mp = shape
    shards = [MeshShard(cfg, specs.counting_groups(dp, mp, r), fsdp=True).shard(whole)
              for r in range(dp * mp)]
    plan = sharding.shard_plan(cfg, mp)
    cut_any = False
    for key, leaf in sharding._walk(whole):
        parts = []
        for m in range(mp):
            data = sharding.fsdp_slice(cfg, plan, 0, dp, key, tuple(leaf.shape))
            slices = [dict(sharding._walk(shards[d * mp + m]))[key] for d in range(dp)]
            cut_any |= data is not None
            parts.append(slices[0] if data is None else torch.cat(slices, data[0]))
        got = sharding.unshard_leaf(cfg, mp, key, parts) if mp > 1 else parts[0]
        assert torch.equal(got, leaf), key
    assert cut_any
