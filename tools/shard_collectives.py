#!/usr/bin/env python3
"""What a head-sharded engine's collectives cost between ranks that share
one card.

    python3 tools/shard_collectives.py [--ranks 2] [--rows 4] [--iters 100]
        [--grad-bytes 1073741824] [--gather-bytes 154836480]

Starts ``--ranks`` rank processes on ``cuda:0`` with ``spawn_ranks`` (the
backend ``shard_backend`` picks for them: ``gloo``, since NCCL refuses two
ranks on one card), and in each: whether ``all_reduce`` takes CUDA tensors
in f32 and bf16 and ``broadcast`` a CUDA tensor (the sums and the
broadcast value, or the error), then the mean host wall of one in-place
all-reduce of a ``--rows`` x 4096 f32 CUDA tensor (a decode step's
activation at qwen3-8b's width, 4 slots) and of one
``ShardGroup.agree`` of a small tuple (a rank-0 decision), each over
``--iters`` calls ending in a synchronise; then, with every rank doing the
same at once, the fenced wall of one down-projection of a rank's shard at
qwen3-8b's mp = 2 shapes (``--rows`` and 128 rows of 2048 or 6144 bf16
columns onto 4096): the bf16 product, the f32 product of the upcast
operands, ``torch.mm(..., out_dtype=torch.float32)`` where this build has
it, and ``project_out`` under a scope that splits the block (the f32
partial, its all-reduce and the rounding); then what training on a mesh
asks: a MAX all-reduce of f32 and a SUM of int32 on CUDA tensors (what
``compressed_psum`` sends), each checked and timed on 4 MiB, and one f32
all-reduce of ``--grad-bytes`` (a data group's gradient sync); then what
fsdp asks: whether ``all_gather`` takes bf16 CUDA tensors and
``reduce_scatter`` f32 ones (their values, or the error), each timed on a
layer's bf16 weights of full-width h2o-danube-3-4b's shape (``--gather-bytes``, a
rank's slice; bytes sent, a rank's) and the f32 gradient of the whole
layer; and whether ``quantize`` on a CUDA
tensor equals the same call on its CPU copy, bit for bit, on 10^6 values
that include exact multiples of amax/127.  Prints the card's name and
power limit, one line a rank, and as its last line a JSON object of every
rank's results.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def measure(group, rows, iters, grad_bytes, gather_bytes):
    import torch
    import torch.distributed as dist
    out = {"rank": group.rank, "backend": group.backend}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((rows, 4096), float(group.rank + 1), device="cuda", dtype=dt)
        try:
            group.all_reduce_(x)
            torch.cuda.synchronize()
            out[f"all_reduce_{str(dt)[6:]}"] = float(x[0, 0])
        except RuntimeError as e:
            out[f"all_reduce_{str(dt)[6:]}"] = f"{type(e).__name__}: {e}"[:300]
    y = torch.full((8,), float(group.rank), device="cuda")
    try:
        dist.broadcast(y, src=0)
        torch.cuda.synchronize()
        out["broadcast"] = float(y[0])
    except RuntimeError as e:
        out["broadcast"] = f"{type(e).__name__}: {e}"[:300]
    x = torch.ones((rows, 4096), device="cuda")
    group.all_reduce_(x)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        group.all_reduce_(x)
    torch.cuda.synchronize()
    out["all_reduce_us"] = (time.perf_counter() - t) / iters * 1e6
    t = time.perf_counter()
    for _ in range(iters):
        group.agree(("decide", 1))
    out["agree_us"] = (time.perf_counter() - t) / iters * 1e6
    out["down_projection_us"] = down_projections(group, rows, iters)
    out.update(training_collectives(group, grad_bytes))
    out.update(fsdp_collectives(group, gather_bytes))
    out["quantize_cuda_equals_cpu"] = quantize_cuda_equals_cpu(group.rank)
    return out


def fsdp_collectives(group, gather_bytes):
    """Gloo's all-gather of a bf16 CUDA slice of ``gather_bytes`` and the
    reduce-scatter of the whole f32 gradient back to slices: checked on
    small tensors, then the mean fenced wall of 3 calls each."""
    import torch
    import torch.distributed as dist
    out = {}
    w = group.world
    x = torch.full((4,), float(group.rank + 1), device="cuda", dtype=torch.bfloat16)
    parts = [torch.empty_like(x) for _ in range(w)]
    try:
        dist.all_gather(parts, x)
        torch.cuda.synchronize()
        out["all_gather_bf16"] = [float(p[0]) for p in parts]
    except RuntimeError as e:
        out["all_gather_bf16"] = f"{type(e).__name__}: {e}"[:300]
    chunks = [torch.full((4,), float(10 * r + group.rank + 1), device="cuda")
              for r in range(w)]
    red = torch.empty(4, device="cuda")
    try:
        dist.reduce_scatter(red, chunks)
        torch.cuda.synchronize()
        out["reduce_scatter_f32"] = dict(value=float(red[0]), expected=float(
            sum(10 * group.rank + r + 1 for r in range(w))))
    except RuntimeError as e:
        out["reduce_scatter_f32"] = f"{type(e).__name__}: {e}"[:300]
    n = gather_bytes // 2
    x = torch.ones((n,), device="cuda", dtype=torch.bfloat16)
    parts = [torch.empty_like(x) for _ in range(w)]
    g = [torch.ones((n,), device="cuda") for _ in range(w)]
    red = torch.empty((n,), device="cuda")
    for name, fn in (("all_gather", lambda: dist.all_gather(parts, x)),
                     ("reduce_scatter", lambda: dist.reduce_scatter(red, g))):
        if isinstance(out.get(f"{name}_{'bf16' if name == 'all_gather' else 'f32'}"), str):
            continue
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        sent = gather_bytes if name == "all_gather" else w * n * 4
        out[f"{name}_timed"] = dict(bytes=sent, us=(time.perf_counter() - t) / 3 * 1e6)
    return out


def quantize_cuda_equals_cpu(seed):
    """(equal, elements that differ) of ``quantize`` on CUDA and on the CPU
    copy of the same 10^6 values; and, for the cause, how many of the
    4096 block scales ``amax / 127.0`` (a Python scalar: a multiply by the
    reciprocal on CUDA) gives differently on CUDA and on the CPU, against
    ``amax / torch.full_like(amax, 127.0)`` (what ``quantize`` does)."""
    import torch
    from repro_torch.optim.compression import quantize
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((1 << 20,), generator=gen)
    blocks = x.reshape(-1, 256)
    amax = blocks.abs().amax(1, keepdim=True)
    k = torch.randint(-127, 128, blocks.shape, generator=gen).float()
    on_grid = torch.rand(blocks.shape, generator=gen) < 0.5
    x = torch.where(on_grid, k * (amax / torch.full_like(amax, 127.0)), blocks).reshape(-1)
    qc, sc = quantize(x.cuda())
    q, s = quantize(x)
    amax = x.reshape(-1, 256).abs().amax(1, keepdim=True)
    by_scalar = int(((amax.cuda() / 127.0).cpu() != amax / 127.0).sum())
    by_tensor = int(((amax.cuda() / torch.full_like(amax.cuda(), 127.0)).cpu()
                     != amax / torch.full_like(amax, 127.0)).sum())
    return dict(equal=bool(torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)),
                q_differ=int((qc.cpu() != q).sum()),
                scales_differ_by_python_scalar=by_scalar,
                scales_differ_by_device_tensor=by_tensor)


def training_collectives(group, grad_bytes):
    """What training on a mesh and ``compressed_psum`` ask of gloo on CUDA
    tensors: a MAX all-reduce of f32 (the agreed block scales) and a SUM
    of int32 (the requantized values), each checked and timed, and the
    mean fenced wall of one f32 all-reduce of ``grad_bytes`` (a data
    group's gradient sync) over 3 calls."""
    import torch
    import torch.distributed as dist
    out = {}
    for name, dt, op, want in (("max_f32", torch.float32, dist.ReduceOp.MAX,
                                float(group.world)),
                               ("sum_int32", torch.int32, dist.ReduceOp.SUM,
                                float(group.world * (group.world + 1) // 2))):
        x = torch.full((1 << 20,), group.rank + 1, device="cuda", dtype=dt)
        try:
            dist.all_reduce(x, op=op)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(10):
                dist.all_reduce(x.fill_(group.rank + 1), op=op)
            torch.cuda.synchronize()
            out[f"all_reduce_{name}"] = dict(value=float(x[0]), expected=want,
                                             us=(time.perf_counter() - t) / 10 * 1e6,
                                             bytes=x.numel() * x.element_size())
        except RuntimeError as e:
            out[f"all_reduce_{name}"] = f"{type(e).__name__}: {e}"[:300]
    g = torch.ones((grad_bytes // 4,), device="cuda")
    group.all_reduce_(g)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        group.all_reduce_(g)
    torch.cuda.synchronize()
    out["grad_all_reduce"] = dict(bytes=grad_bytes,
                                  us=(time.perf_counter() - t) / 3 * 1e6)
    return out


def down_projections(group, rows, iters):
    """{"rows x K": {variant: mean fenced µs}} of one down-projection."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.group import ShardScope, project_out, shard_scope
    from repro_torch.distributed.sharding import shard_plan
    plan = shard_plan(get_config("qwen3-8b"), group.world)
    gen = torch.Generator("cuda").manual_seed(group.rank)
    out = {}
    for m in (rows, 128):
        for k in (2048, 6144):
            h = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            w = torch.randn((k, 4096), generator=gen, device="cuda").bfloat16()
            variants = {"bf16": lambda: h @ w,
                        "f32_upcast": lambda: h.float() @ w.float()}
            try:
                torch.mm(h, w, out_dtype=torch.float32)
                variants["f32_out_dtype"] = lambda: torch.mm(h, w, out_dtype=torch.float32)
            except (RuntimeError, TypeError) as e:
                out[f"{m}x{k} out_dtype"] = f"{type(e).__name__}: {e}"[:120]

            def split():
                with shard_scope(ShardScope(group, plan)):
                    return project_out(h, w, "ffn")
            variants["project_out"] = split
            res = {}
            for name, fn in variants.items():
                fn()
                torch.cuda.synchronize()
                group.agree(None)
                t = time.perf_counter()
                for _ in range(iters):
                    fn()
                    torch.cuda.synchronize()
                res[name] = (time.perf_counter() - t) / iters * 1e6
            out[f"{m}x{k}"] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--grad-bytes", type=int, default=1 << 30,
                    help="bytes of the timed f32 gradient all-reduce")
    # a rank's half of one full-width h2o-danube-3-4b layer in bf16
    ap.add_argument("--gather-bytes", type=int, default=154836480,
                    help="bytes of a rank's bf16 slice in the timed all-gather")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.distributed.group import spawn_ranks
    if not torch.cuda.is_available():
        print("shard_collectives: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = spawn_ranks(measure, ["cuda:0"] * args.ranks, (args.rows, args.iters, args.grad_bytes,
                                                           args.gather_bytes))
    for r in res:
        print(r)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
