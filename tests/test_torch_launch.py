"""The port's launch tooling (``repro_torch.launch.{specs,roofline,dryrun}``)
against ``repro.launch``'s, on the CPU.

* For all 40 (arch x shape) cells: ``shape_applicable``, ``model_flops``,
  ``auto_tp``, ``auto_fsdp`` and ``effective_microbatches`` equal the
  reference's (its policies on ``tests/test_distributed.py``'s fake
  mesh); ``probe_configs`` and ``extrapolate_depth`` on the cases of
  ``tests/test_launch.py``.
* A rank's state bytes: full-width h2o-danube-3-4b cut to 4 layers, bf16
  params and f32 master, m and v, at (1, 1), (2, 1), (1, 2), (2, 2) with
  and without fsdp, against the reckoning from ``param_shapes``; and leaf
  by leaf against the reference's ``param_specs(..., fsdp=True)`` at
  (2, 2) and, for qwen3-8b, at (16, 16), every departure listed with its
  excess bytes.

The dry run's counts are held in ``tests/test_torch_dryrun.py``.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES_BY_NAME as JSHAPES  # noqa: E402
from repro.configs import shape_applicable as jshape_applicable  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, SHAPES_BY_NAME, ShapeConfig  # noqa: E402
from repro_torch.configs import get_config, shape_applicable  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import roofline, specs  # noqa: E402

CELLS = [(a, s.name) for a in ARCHS for s in SHAPES]
DANUBE = "h2o-danube-3-4b"
GB = 1e9


def fake_mesh(shape=(16, 16)):
    from tests.test_distributed import fake_mesh as fm
    return fm(shape)


def test_the_same_40_cells():
    assert sorted(ARCHS) == sorted(JARCHS) and len(CELLS) == 40
    assert [dataclasses.asdict(s) for s in SHAPES] == \
        [dataclasses.asdict(JSHAPES[s.name]) for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_policies_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), JARCHS[arch]
    s, js = SHAPES_BY_NAME[shape], JSHAPES[shape]
    assert shape_applicable(cfg, s) == jshape_applicable(jcfg, js)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for n_dev in (256, 512):
        assert roofline.model_flops(cfg, s, n_dev) == jroofline.model_flops(jcfg, js, n_dev)
    mesh, jmesh = specs.dry_mesh(16, 16), fake_mesh()
    assert specs.auto_tp(cfg, mesh) == jspecs.auto_tp(jcfg, jmesh)
    assert specs.auto_fsdp(cfg, mesh) == jspecs.auto_fsdp(jcfg, jmesh)
    for bkw in ({}, {"tp": False}, {"num_microbatches": 4}):
        assert specs.effective_microbatches(cfg, s, mesh, bkw) == \
            jspecs.effective_microbatches(jcfg, js, jmesh, bkw)


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b", "whisper-base"])
def test_probe_configs_match_reference(arch):
    cfgs, total = roofline.probe_configs(get_config(arch))
    jcfgs, jtotal = jroofline.probe_configs(JARCHS[arch])
    assert [dataclasses.asdict(c) for c in cfgs] == [dataclasses.asdict(c) for c in jcfgs]
    vals = [(1.0, 2.0, 3.0), (2.5, 4.0, 3.5), (4.0, 5.0, 9.0)][:len(cfgs)]
    got = total(*(roofline.Probe(*v) for v in vals))
    want = jtotal(*(jroofline.Probe(*v) for v in vals))
    assert (got.flops, got.bytes_accessed, got.collective_bytes) == pytest.approx(
        (want.flops, want.bytes_accessed, want.collective_bytes))


def test_extrapolate_depth_matches_reference():
    for p1, p2, depth, rep in (((10, 10, 10), (9, 9, 9), 32, 1.0),
                               ((1, 2, 3), (3, 5, 4), 36, 16.0)):
        got = roofline.extrapolate_depth(roofline.Probe(*p1), roofline.Probe(*p2), depth,
                                         repeats=rep)
        want = jroofline.extrapolate_depth(jroofline.Probe(*p1), jroofline.Probe(*p2),
                                           depth, repeats=rep)
        assert (got.flops, got.bytes_accessed, got.collective_bytes) == \
            (want.flops, want.bytes_accessed, want.collective_bytes)


# -- a rank's bytes -----------------------------------------------------------------------

def danube4():
    return dataclasses.replace(get_config(DANUBE), num_layers=4)


# bf16 params + f32 master, m, v, and AdamW's int32 step; (1, 1), (2, 1),
# (1, 2), (2, 2), reckoned from param_shapes: 865,109,760 parameters, of
# which 245,760,000 are embed + lm_head (whole on every model rank) and
# 34,560 the norms (whole on every rank)
STATE_GB = {((1, 1), True): 12.112, ((2, 1), True): 6.056, ((1, 2), True): 7.776,
            ((2, 2), True): 3.888, ((2, 1), False): 12.112, ((2, 2), False): 7.776}


@pytest.mark.parametrize("mesh,fsdp", list(STATE_GB), ids=[f"{m[0]}x{m[1]}-fsdp{f}"
                                                           for m, f in STATE_GB])
def test_state_bytes_a_rank(mesh, fsdp):
    cfg = danube4()
    shape = ShapeConfig("mesh", "train", 4096, 2)
    built = specs.build_train(cfg, shape, specs.dry_mesh(*mesh), fsdp=fsdp, tp=True)
    got = specs.tree_bytes(built.state)
    assert round(got / GB, 3) == STATE_GB[(mesh, fsdp)]
    # the count from the leaves' shapes: embed + lm_head over data only,
    # norms whole, the rest over both axes
    dp, mp = mesh
    embed, norms = 245_760_000, 34_560
    rest = 865_109_760 - embed - norms
    n = norms + (embed + rest // mp) // (dp if fsdp else 1)
    assert got == n * 14 + 4


def _local_shapes_ref(jcfg, mesh):
    jm = fake_mesh(mesh)
    sizes = dict(zip(jm.axis_names, jm.devices.shape))
    av = jmodel.param_specs(jcfg)
    spec = jshard.param_specs(av, jm, fsdp=True)
    out = {}
    for (path, leaf), s in zip(jax.tree_util.tree_flatten_with_path(av)[0],
                               jax.tree.leaves(spec, is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec))):
        shape = list(leaf.shape)
        for i, axes in enumerate(s):
            for a in (axes if isinstance(axes, tuple) else (axes,)) if axes else ():
                shape[i] //= sizes[a]
        out[jax.tree_util.keystr(path)] = (tuple(shape), leaf.dtype.itemsize)
    return out


def _local_shapes_port(cfg, mesh):
    shard = specs.build_train(cfg, ShapeConfig("s", "train", 64, mesh[0]),
                              specs.dry_mesh(*mesh), fsdp=True, tp=True)
    return {k: tuple(v.shape) for k, v in sharding._walk(shard.args[0])}


# the leaves whose rank shape departs from the rules', by mesh: embed and
# lm_head whole over model (the port's split keeps them whole), and at
# qwen3-8b's (16, 16) the KV weights of the KV head a rank's query heads
# read (Hkv = 8 over 16 ranks), where the rules cut H * head_dim in 16
DEPARTURES = {
    (DANUBE, (2, 2)): {"['embed']", "['lm_head']"},
    ("qwen3-8b", (16, 16)): {"['embed']", "['lm_head']", "['layers']['attn_wk']",
                             "['layers']['attn_wv']"},
}


@pytest.mark.parametrize("arch,mesh", list(DEPARTURES), ids=["danube-2x2", "qwen3-16x16"])
def test_leaf_shapes_match_reference_param_specs(arch, mesh, capsys):
    cfg = danube4() if arch == DANUBE else get_config(arch)
    jcfg = dataclasses.replace(JARCHS[arch], num_layers=cfg.num_layers)
    ref, got = _local_shapes_ref(jcfg, mesh), _local_shapes_port(cfg, mesh)
    assert set(ref) == set(got)
    differ = {k for k in ref if ref[k][0] != got[k]}
    assert differ == DEPARTURES[(arch, mesh)]
    excess = {k: (math.prod(got[k]) - math.prod(ref[k][0])) * ref[k][1] for k in differ}
    assert all(e > 0 for e in excess.values())
    with capsys.disabled():
        print(f"\n{arch} at {mesh}, fsdp: bytes a rank holds beyond the rules' "
              f"(bf16 params): {excess}")
