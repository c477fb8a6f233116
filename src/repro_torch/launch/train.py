"""Training launcher of the port.

    python -m repro_torch.launch.train --arch h2o-danube-3-4b \\
        --steps 8 --batch 1 --seq 4096 [--ckpt DIR] [--device cuda]
    python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
        --steps 4 --batch 4 --seq 32 --device cpu [--mesh 2,2]

The flags are those of ``repro.launch.train``; an encdec arch
(whisper-base) is refused, since ``SyntheticStream`` yields no frames.
Every other family trains on any mesh, the recurrent ones (rwkv6-7b,
zamba2-1.2b) split over the model axis too.
``--smoke`` trains the reduced config on one device; without it the full
config is trained on the production mesh (``launch.mesh``: the
``(data, model)`` grid over the visible cards).  ``--mesh DP,MP`` trains
on a grid of DP*MP ranks, one process each (``spawn_ranks``), on the
devices ``--device`` names: a comma list of DP*MP devices, or ``cpu``
(every rank on the CPU) or ``cuda`` (rank r on ``cuda:{r % cards}``:
ranks may share a card, over gloo).  As the reference's launcher
(``param_shardings(..., fsdp=True)``), a mesh shards the parameters and
the optimizer state over ``data`` as well as ``model`` (fsdp, gathered a
layer at a time; the report line says ``[mesh 2x1, fsdp]``).  Every rank
draws the parameters from ``--seed``, keeping its slice of each leaf as
it is drawn; rank 0's lines are printed.  ``--resume`` restores the
checkpoint whatever mesh wrote it.
The VPE trials the family's implementation axes (``attn_impl``:
``reference``, ``flash_cuda``; ``ssd_impl`` or ``wkv_impl``:
``chunked``, ``sequential``) inside the loop unless ``--no-vpe``; its
decision table is printed at the end.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.distributed.group import MeshGroups, spawn_ranks
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.serve import NO_FRAMES
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig


def mesh_devices(spec: str, n: int) -> List[str]:
    """``n`` rank devices from ``--device``: a list of ``n``, or one kind."""
    devices = spec.split(",")
    if len(devices) == n:
        return devices
    if devices == ["cpu"]:
        return ["cpu"] * n
    if devices == ["cuda"]:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not cards:
            raise RuntimeError("--device cuda: no CUDA card is visible")
        return [f"cuda:{r % cards}" for r in range(n)]
    raise ValueError(f"--device names {len(devices)} devices for {n} ranks")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--no-vpe", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, metavar="DP,MP",
                    help="train on a (data, model) grid of DP*MP ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernel versions); "
                         "with --mesh, a comma list of DP*MP devices, or one "
                         "kind for all ranks")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family == "encdec":
        ap.error(NO_FRAMES.format(arch=args.arch))
    if args.smoke:
        cfg = cfg.reduced()
    if args.mesh is not None:
        try:
            shape = tuple(int(x) for x in args.mesh.split(","))
        except ValueError:
            shape = ()
        if len(shape) != 2 or min(shape) < 1:
            ap.error(f"--mesh must be 'dp,mp' integers >= 1, got {args.mesh!r}")
        try:
            devices = mesh_devices(args.device, shape[0] * shape[1])
        except (ValueError, RuntimeError) as e:
            ap.error(str(e))
    else:
        mesh = make_host_mesh(args.device) if args.smoke else make_production_mesh()
        shape, devices = mesh.shape, list(mesh.devices)
    if shape == (1, 1):
        lines = _train(None, args, cfg, shape, devices[0])
    else:
        lines = spawn_ranks(_train, devices, (args, cfg, shape, None))[0]
    print("\n".join(lines))


def _train(group, args, cfg, shape: Tuple[int, int],
           device: Optional[str]) -> List[str]:
    """Train on one device (``group`` None) or as rank ``group.rank`` of
    the ``shape`` grid, on the current device; rank 0's report lines."""
    if group is not None:
        device = (f"cuda:{torch.cuda.current_device()}"
                  if args.device.split(",")[0].startswith("cuda") else "cpu")
    data = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, peak_lr=args.lr,
        warmup_steps=max(args.steps // 10, 1),
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt,
        num_microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        enable_vpe=not args.no_vpe,
        log_every=max(args.steps // 20, 1) if group is None or group.rank == 0 else 0,
    )
    mesh = MeshGroups(group, *shape) if group is not None else None
    loop = TrainLoop(cfg, loop_cfg, data, seed=args.seed, device=device, mesh=mesh,
                     fsdp=True)
    lines = []
    if args.resume and loop.restore():
        lines.append(f"resumed from step {loop.step}")
    metrics = loop.run()
    note = ""
    if group is not None:
        note = f" [mesh {shape[0]}x{shape[1]}{', fsdp' if loop.mesh.fsdp else ''}]"
    lines.append(f"done: {loop.step} steps{note}; "
                 f"loss {metrics[0]['loss']:.4f} -> {metrics[-1]['loss']:.4f}")
    lines.append(loop.vpe.report())
    if args.ckpt:
        loop.save()
    return lines if group is None or group.rank == 0 else []


if __name__ == "__main__":
    main()
