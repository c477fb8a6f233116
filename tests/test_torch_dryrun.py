"""The port's dry run (``repro_torch.launch.dryrun``) on the meta device, on
the CPU.

* A dense train cell's FLOP count at full depth equals the depth-probe
  extrapolation (``roofline.probe_configs``) exactly: an eager count is
  linear in the layers.
* One arch of each family at its shapes runs, or is skipped with its
  reason (quadratic attention at 524288 tokens; the recurrent and
  encoder-decoder families at mp > 1); the recurrent families run on a
  data-only grid, cut in depth, since an eager count walks every scan
  chunk.  Each prints its ``model_flops / hlo_flops``.
* The collectives counted at (1, 2), and at (2, 1) under fsdp, equal what
  a two-process gloo run of the same step records through its real group
  (``tests/torch_launch_ranks.py``, which imports no JAX): bytes and calls
  by kind.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_launch_ranks as ranks  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.distributed.group import spawn_ranks  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402

DANUBE = "h2o-danube-3-4b"


# -- the dry run -------------------------------------------------------------------------

def test_dense_train_flops_equal_the_depth_probes(capsys):
    """h2o-danube-3-4b train_4k at (16, 16), full depth: 24 layers, 16
    microbatches counted at one and two."""
    r = dryrun.run_cell(DANUBE, "train_4k")
    assert r["cost_analysis"]["flops"] == r["probe_totals"]["flops"]
    assert r["num_microbatches"] == 16 and r["tp"] and not r["fsdp"]
    assert r["collectives"]["counts"]["all-reduce"] > 0
    with capsys.disabled():
        print(f"\n{DANUBE} train_4k (16, 16): model_flops / hlo_flops "
              f"{r['roofline']['useful_ratio']}, hlo flops a rank "
              f"{r['cost_analysis']['flops']}")


# one arch a family, at its applicable shapes; the recurrent families on a
# data-only grid (they are not head-split) and cut in depth, since an eager
# count walks every scan chunk
# (arch, shape, mesh, config overrides, skipped)
FAMILY_CELLS = [
    ("qwen2-moe-a2.7b", "decode_32k", (16, 16), {}, False),
    ("chameleon-34b", "decode_32k", (16, 16), {}, False),
    ("whisper-base", "train_4k", (16, 16), {}, False),
    ("whisper-base", "decode_32k", (16, 16), {}, True),     # not head-split
    ("whisper-base", "decode_32k", (16, 1), {}, False),
    ("rwkv6-7b", "long_500k", (16, 1), {"num_layers": 2}, False),
    ("zamba2-1.2b", "long_500k", (16, 1), {"num_layers": 12}, False),
    ("zamba2-1.2b", "decode_32k", (16, 16), {}, True),      # not head-split
    (DANUBE, "long_500k", (16, 16), {}, False),
    ("qwen3-8b", "long_500k", (16, 16), {}, True),          # quadratic
]


@pytest.mark.parametrize("arch,shape,mesh,over,skipped", FAMILY_CELLS,
                         ids=[f"{a}-{s}-{m[0]}x{m[1]}" for a, s, m, *_ in FAMILY_CELLS])
def test_family_cells(arch, shape, mesh, over, skipped, capsys):
    r = dryrun.run_cell(arch, shape, mesh=mesh, overrides=over)
    if skipped:
        assert "skipped" in r and r["skipped"], r
        return
    assert "skipped" not in r
    assert r["cost_analysis"]["flops"] > 0 and r["arg_bytes_per_device"] > 0
    assert r["probe_totals"]["flops"] == pytest.approx(r["cost_analysis"]["flops"],
                                                       rel=0.05)
    with capsys.disabled():
        print(f"\n{arch} {shape} {mesh}: model_flops / hlo_flops "
              f"{r['roofline']['useful_ratio']}, dominant {r['roofline']['dominant']}")


def test_whisper_trains_data_parallel_over_both_axes():
    """Below 1e9 parameters (auto_tp) the model is whole on every rank and
    the batch shards over all 256: the reference's pure data parallelism,
    a (256, 1) grid here."""
    r = dryrun.run_cell("whisper-base", "train_4k", probes=False)
    assert r["rank_mesh"] == [256, 1] and not r["tp"] and r["num_microbatches"] == 1


# the step both sides run: reduced qwen3-8b, f32, a global batch of 4 x 32
COLL_SHAPE = ShapeConfig("coll", "train", 32, 4)


@pytest.mark.parametrize("mesh,fsdp", [((1, 2), False), ((2, 1), True)],
                         ids=["1x2", "2x1-fsdp"])
def test_counted_collectives_equal_a_gloo_run(mesh, fsdp):
    cfg = get_config("qwen3-8b").reduced()
    built = specs.build_train(cfg, COLL_SHAPE, specs.dry_mesh(*mesh), fsdp=fsdp, tp=True)
    want = dryrun.count(built)["collectives"]
    got = spawn_ranks(ranks.record_collectives, ["cpu"] * (mesh[0] * mesh[1]),
                      (mesh, fsdp, COLL_SHAPE.global_batch, COLL_SHAPE.seq_len),
                      timeout_s=240)
    assert got[0] == want
    assert want["total"] > 0
    if fsdp:
        assert want["counts"]["all-gather"] > 0 and want["counts"]["reduce-scatter"] > 0
