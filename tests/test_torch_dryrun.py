"""The port's dry run (``repro_torch.launch.dryrun``) on the meta device, on
the CPU.

* A dense train cell's FLOP count at full depth equals the depth-probe
  extrapolation (``roofline.probe_configs``) exactly: an eager count is
  linear in the layers.
* One arch of each family at its shapes runs, or is skipped with its
  reason (quadratic attention at 524288 tokens, the only skip: every
  family splits over the model axis); the recurrent families' long and
  train cells run cut in depth, since an eager count walks every scan
  chunk.  Each prints its ``model_flops / hlo_flops``.  At (16, 16) the
  40 cells are 33 to run and 7 skips, none of them for its family.
* A recurrent family's step counted at the depths of ``depth_probes``
  and combined equals its full-depth count.
* qwen3-8b train_4k at (16, 16) with ``compress_grads`` runs, its error
  feedback's block-scale MAX counted as an all-reduce of its own kind.
* The collectives counted at (1, 2), and at (2, 1) under fsdp, equal what
  a two-process gloo run of the same step records through its real group
  (``tests/torch_launch_ranks.py``, which imports no JAX): bytes and calls
  by kind.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_launch_ranks as ranks  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, SHAPES_BY_NAME, ShapeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
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


# one arch a family, at its applicable shapes; the recurrent families' long
# and train cells cut in depth, since an eager count walks every scan chunk
# (arch, shape, mesh, config overrides, skipped)
FAMILY_CELLS = [
    ("qwen2-moe-a2.7b", "decode_32k", (16, 16), {}, False),
    ("chameleon-34b", "decode_32k", (16, 16), {}, False),
    ("whisper-base", "train_4k", (16, 16), {}, False),
    ("whisper-base", "decode_32k", (16, 16), {}, False),    # the MLP splits, 8 heads not
    ("whisper-base", "decode_32k", (16, 1), {}, False),
    ("rwkv6-7b", "long_500k", (16, 1), {"num_layers": 2}, False),
    ("rwkv6-7b", "train_4k", (16, 16), {"num_layers": 2}, False),
    ("zamba2-1.2b", "long_500k", (16, 1), {"num_layers": 12}, False),
    ("zamba2-1.2b", "decode_32k", (16, 16), {}, False),     # 4 Mamba2 heads a rank
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


def test_the_sweep_runs_33_cells_and_skips_7():
    """At (16, 16) only the quadratic archs' long_500k cells are skipped
    (the sweep's ``dryrun --all`` gives 33 ok, 7 skipped, 0 error; phase
    17d of ``chip_smoke.py`` runs it), and no reason names a family."""
    reasons = [dryrun.skip_reason(get_config(a), s) for a in ARCHS for s in SHAPES]
    skipped = [r for r in reasons if r]
    assert len(reasons) == 40 and len(skipped) == 7
    assert all("524288" in r and "family" not in r for r in skipped), skipped
    assert not any(get_config(a).subquadratic and dryrun.skip_reason(get_config(a), s)
                   for a in ARCHS for s in SHAPES)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_depth_probes_give_the_full_depth_count(arch, monkeypatch):
    """decode_32k at (16, 16): the count at the probe depths, combined,
    equals the full-depth count (FLOPs, bytes, saved bytes, collectives)."""
    cfg, shape = get_config(arch), SHAPES_BY_NAME["decode_32k"]
    mesh = specs.dry_mesh(16, 16)
    assert dryrun.depth_probes(cfg) is not None
    _, probed = dryrun.count_step(cfg, shape, mesh, {})
    monkeypatch.setattr(dryrun, "depth_probes", lambda cfg: None)
    _, full = dryrun.count_step(cfg, shape, mesh, {})
    assert probed == full


def test_compress_grads_cell_at_16x16_runs():
    """The error feedback's block-scale MAX goes through the rank's group
    object, so a ``compress_grads`` cell at mp > 1 runs on the counting
    group and counts it under its own kind."""
    r = dryrun.run_cell("qwen3-8b", "train_4k", probes=False,
                        build_kwargs={"compress_grads": True})
    assert "error" not in r and "skipped" not in r and r["tp"]
    counts = r["collectives"]["counts"]
    assert counts["all-reduce-max"] > 0 and counts["all-reduce"] > 0


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
