#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--report FILE] [--trace DIR]

Phases, each printed as it runs; any failure raises and exits non-zero:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: one ``nvcc`` per ``.cu`` source in ``csrc/``, all started
   together, and one link (serving: paged decode, split-K in two or three
   launches, and prefill attention; training: flash attention; the paper
   path: matmul and conv2d; the bf16 bodies of prefill and flash share
   ``attention_tile.cuh``), with each kernel's registers and spills and any
   wgmma serialization ptxas reports;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   (paged kernels at qwen3-8b's head shapes; the flash kernel at
   h2o-danube-3-4b's and qwen3-8b's, the training path's 4096 tokens
   among them, and the autograd wiring of its gradient), bf16 (the
   tensor-core bodies of flash and prefill) and f32 (CUDA-core bodies);
   then, at the shapes its path gives it, its time beside its plain
   version's, one PyTorch library call's (timed only: the port never calls
   it) and its bound;
4. serving path: full-width qwen3-8b, all 36 layers (random weights from
   a seeded generator on the card), served by the continuous-batching
   engine on the paged layout with both paged kernels pinned, one decode
   step a call, each call a replay of a CUDA graph the engine captured in
   its warm-up requests (no capture may fall in the timed run); the launch
   counts are zeroed just before the run and read just after (decode: the
   wrapper's own calls plus the calls the replays stand for, one a layer
   a step), and the graphs' captures and pool bytes printed; then a steady
   window on the same engine: 8 decode calls at 4 busy slots timed on the
   host and, around each replay, with CUDA events (unprofiled: the
   device's idle time a step), and one more call under torch.profiler,
   whose device launches of the paged decode kernels must be 3 a layer a
   step;
4b. fused horizons: phase 4's engine and traffic with ``decode_horizon=16``
   pinned (16 steps a replay); the same gates and steady window (2 calls),
   and each request's tokens equal to phase 4's;
4c. ``decode_horizon="auto"``: phase 4's traffic three times on one
   engine, each pass's tokens equal to phase 4's; the VPE's decisions on
   the horizon axis printed;
5. serving parity: reduced qwen3-8b in f32, kernels against the gather
   path, greedy tokens equal, and fused horizons of 4 and 16 steps against
   single steps for both decode variants, plus an EOS that stops a horizon
   midway (tokens end at the first EOS); full width in bf16, first-step
   logits of the two;
7. training path: full h2o-danube-3-4b, all 24 layers (bf16 params, f32
   master/m/v, 1 x 4096 tokens, remat), trained by ``TrainLoop``: first
   with the VPE free until it concludes its ``attn_impl`` trial, then with
   ``flash_cuda`` pinned, the flash launch count zeroed just before those
   steps and read just after; then a full-size checkpoint save and
   restore of the params, the f32 master copy and the step (23.8 GB),
   every leaf zeroed before the restore and compared bit for bit after it
   (m and v stay out: the whole state, 55.5 GB, would pass the 45 GiB this
   script may write to disk);
8. training parity: reduced h2o-danube-3-4b in f32, loss and gradients
   and three loop steps of ``flash_cuda`` against ``reference``;
9. paper-path kernels: matmul and conv2d against their plain versions on
   the card, f32 and bf16 (matmul at tests/test_kernels.py's shapes, 512^3,
   1000^3 off every tile and 4096^3; conv2d at the JAX tests' shapes,
   10^2 * 5x5, 512^2 * 5x5 and 384^2 * 3x3);
10. their times at the paper path's shapes (matmul 512^3 and 4096^3,
   conv2d 512^2 * 5x5 and 384^2 * 3x3, f32) beside the plain version's, one
   library call's and the bound;
11. the paper path, its launch counts zeroed just before it and read just
   after: (a) Table 1, the six algorithms at the paper's sizes under the
   VPE, 12 calls each; (b) the Fig. 2b matmul sweep, 16 to 4096, each
   variant timed and each size bucket learnt by the VPE; (c) the Fig. 3
   image pipeline (``repro_torch.examples.image_pipeline``); (d) the
   quickstart (``repro_torch.examples.quickstart``).  Then the outputs are
   checked: each Table-1 algorithm's output under the VPE's decision
   against its reference variant, the sweep's kernel outputs against the
   plain version (launches made for these checks are not counted).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without ``src/repro_torch`` beside this script, it exits non-zero and
prints no result.  ``--report`` also writes every measurement as JSON;
``--trace`` adds phase 6, which profiles 8 steady single decode steps, one
steady 16-step horizon (both graph replays) and one prompt's prefill
chunks, and one profiled training step in phase 7 (device busy share,
time by kernel, the profiler's own cost included), and writes the chrome
traces there, gzipped.
"""

from __future__ import annotations

import argparse
import gc
import gzip
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# paged-attention shapes of qwen3-8b and of the main path's engine
HQ, HKV, D, BS = 32, 8, 128, 16
SLOTS, MAX_LEN, CHUNK, NEW_TOKENS, REQUESTS = 4, 1024, 128, 32, 8
NB = MAX_LEN // BS
VOCAB = 151936

# the training path: full h2o-danube-3-4b at 1 x 4096 tokens
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "h2o-danube-3-4b", 1, 4096, 4
# flash kernel checks: (Hq, Hkv, D) of h2o-danube-3-4b and qwen3-8b, and
# (S, T, causal, window): S = T, S < T, T off the 64-key tile, and the
# training path's own shape
FLASH_HEADS = ((32, 8, 120), (32, 8, 128))
FLASH_CASES = ((2048, 2048, True, None), (2048, 2048, True, 1024),
               (2048, 2048, False, None), (2048, 2048, False, 1024),
               (300, 1100, True, 1024), (1000, 1000, True, 4096),
               (TRAIN_SEQ, TRAIN_SEQ, True, 4096))

# the paper path: matmul checks (m, k, n) — tests/test_kernels.py's shapes,
# the Table-1 512^3, one off every tile, the Fig. 2b sweep's largest — and
# conv2d checks (h, w, k) — the JAX tests' shapes, make_inputs at scale
# 0.02, the Table-1 512^2 * 5x5, the image pipeline's 384^2 Laplacian
MATMUL_CHECKS = ((128, 256, 128), (256, 512, 256), (100, 200, 60), (8, 8, 8),
                 (1, 512, 128), (384, 128, 384), (512, 512, 512), (1000, 1000, 1000),
                 (4096, 4096, 4096))
CONV_CHECKS = ((64, 64, 3), (64, 64, 5), (37, 53, 5), (128, 96, 11), (16, 16, 3),
               (66, 64, 3), (10, 10, 5), (512, 512, 5), (384, 384, 3))
# Fig. 2b's sizes (benchmarks/fig2b.py) and three more, where the card works
SWEEP = (16, 32, 64, 96, 128, 192, 256, 384, 512, 1024, 2048, 4096)
TABLE1_CALLS, SWEEP_CALLS, SWEEP_REPS = 12, 10, 3

SOURCES = {
    "paged_decode_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_prefill_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "conv2d": "src/repro_torch/kernels/csrc/conv2d.cu",
}
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/paged_attention.py:352",
    "paged_prefill_attention": "src/repro/kernels/paged_attention.py:268",
    "flash_attention": "src/repro/kernels/flash_attention.py:105",
    "matmul": "src/repro/kernels/matmul.py:48",
    "conv2d": "src/repro/kernels/conv2d.py:41",
}


def say(*parts) -> None:
    print(*parts, flush=True)


def tolerance(dtype, read_dtype) -> tuple:
    """(atol, rtol) of a kernel against its plain version.

    f32: the same sums in another order.  f32 with ``read_dtype``: a
    probability whose f32 value differs in its last bit may round to the
    neighbouring bf16 value, moving the output by that probability's bf16
    step times |v|.  bf16 output: one bf16 rounding step (2^-8 relative)
    of a value whose f32 sum differs in its last bits."""
    import torch
    if dtype == torch.bfloat16:
        return 1e-2, 1e-2
    return (1e-3, 1e-3) if read_dtype is not None else (1e-4, 1e-4)


def flash_tolerance(dtype) -> tuple:
    """(atol, rtol) of the flash kernel against its plain version.  Both
    sum in f32 and round once to the output dtype.  f32: the same sums in
    another order.  bf16: two f32 sums that differ in their last bits round
    at most one bf16 step apart, and a step is at most 2^-7 of the value;
    the atol covers outputs so near 0 that the f32 difference (about 1e-6)
    spans more than a step."""
    import torch
    return (1e-5, 2 ** -7) if dtype == torch.bfloat16 else (1e-4, 1e-4)


def matmul_tolerance(dtype, k) -> tuple:
    """(atol, rtol) of the matmul kernel against its plain version.  f32:
    JAX's 5e-4 up to k = 512, scaled by sqrt(k / 512) above it (the
    rounding error of a sum in another order grows with its length).  bf16:
    the same f32 difference, plus one bf16 step (2^-7 of the value) from
    rounding the two sums once each; an output near 0 whose partial sums
    are not keeps the whole f32 difference, so the f32 atol stays."""
    import torch
    tol = 5e-4 * max(1.0, (k / 512) ** 0.5)
    return (tol, tol + 2 ** -7) if dtype == torch.bfloat16 else (tol, tol)


def conv_tolerance(dtype) -> tuple:
    """(atol, rtol) of the conv2d kernel against its plain version: f32
    JAX's 2e-4; bf16 one bf16 step (both sum at most 121 taps in f32 and
    round once)."""
    import torch
    return (1e-5, 2 ** -7) if dtype == torch.bfloat16 else (2e-4, 2e-4)


def check_close(what: str, got, want, atol: float, rtol: float) -> float:
    import torch
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max())
    excess = float((diff - atol - rtol * want.abs()).max())
    say(f"  {what}: max_abs_err {err} (atol {atol}, rtol {rtol})")
    if excess > 0:
        raise AssertionError(f"{what}: error {err} exceeds atol {atol} + "
                             f"rtol {rtol} * |want|")
    return err


# -- inputs ------------------------------------------------------------------------

def pool_inputs(gen, dtype, n_pages, S, B):
    import torch
    dev = gen.device
    q = torch.randn((B, HQ, S, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_pages, HKV, BS, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n_pages, HKV, BS, D), generator=gen, device=dev).to(dtype)
    return q, kp, vp


def shared_tables(gen, B, n_pages):
    """Random page ids, drawn with repeats, so sequences share pages."""
    import torch
    return torch.randint(0, n_pages, (B, NB), generator=gen, device=gen.device,
                         dtype=torch.int32)


def distinct_tables(gen, B, n_pages):
    """Each sequence owns its pages, as the engine allocates them."""
    import torch
    perm = torch.randperm(n_pages, generator=gen, device=gen.device)
    return perm[:B * NB].reshape(B, NB).to(torch.int32)


# -- work each kernel must do (the bound) ----------------------------------------

def decode_work(bt, lengths, window, elem):
    """(bytes, ops) the decode function needs on these inputs: each page a
    sequence attends to read once (shared pages once), q, tables and
    lengths read, the output written; 4*D ops per (query head, column)."""
    bt, lengths = bt.tolist(), lengths.tolist()
    pages, cols = set(), 0
    for row, L in zip(bt, lengths):
        lo = L - window + 1 if window else 0
        for j in range(NB):
            if j * BS > L:
                break
            if j * BS + BS - 1 >= lo:
                pages.add(row[j])
        cols += L + 1 - max(lo, 0)
    B = len(bt)
    nbytes = (2 * len(pages) * HKV * BS * D * elem + 2 * B * HQ * D * elem
              + B * NB * 4 + B * 4)
    return nbytes, 4 * D * HQ * cols


def prefill_work(bt, base, chunk_len, C, window, elem):
    """(bytes, ops) of chunk attention: every page a query row attends to
    read once, q read, the output written; 4*D ops per (query head,
    valid column) over all C rows."""
    bt, base = bt.tolist(), base.tolist()
    pages, pairs = set(), 0
    for row, b0 in zip(bt, base):
        limit = b0 + chunk_len
        for i in range(C):
            pos = b0 + i
            hi = min(pos, limit - 1)
            lo = max(pos - window + 1, 0) if window else 0
            if hi < lo:
                continue
            pairs += hi - lo + 1
            for j in range(lo // BS, hi // BS + 1):
                pages.add(row[j])
    B = len(bt)
    nbytes = (2 * len(pages) * HKV * BS * D * elem + 2 * B * HQ * C * D * elem
              + B * NB * 4 + B * 4)
    return nbytes, 4 * D * HQ * pairs


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- timing ------------------------------------------------------------------------

def device_ms(fn, flush, iters=20):
    """Median device time of one call, in ms: CUDA events around each call,
    with the L2 cache (50 MB) flushed before it, as a layer of the model
    finds its pages cold."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


# -- phases --------------------------------------------------------------------------

def phase_environment():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(f"[1] environment: python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    say(smi)
    return smi


def phase_build():
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    log = build.build()
    seconds = time.perf_counter() - t0
    lib = build.load_library()
    entry, spilled = None, []
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "Performance Loss")):
            say(f"  {line.strip()}")
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "spill stores" in line and any(int(x) for x in re.findall(r"\d+", line)):
            spilled.append(entry)
    say(f"  kernels with a stack frame or spills: {spilled or 'none'}")
    from repro_torch.kernels import paged_attention as pa
    splits, kps = pa.decode_split_plan(SLOTS, HKV, NB, BS, build.sm_count(
        torch.device("cuda", 0)))
    say(f"  dynamic shared memory of a bf16 prefill block: "
        f"{lib.repro_paged_prefill_smem(D, BS, 1)} B; of a bf16 decode block "
        f"at the main path's plan ({splits} splits of {kps} keys): "
        f"{lib.repro_paged_decode_smem(D, BS, kps, 1)} B")
    say(f"[2] build: nvcc {seconds} s, {time.perf_counter() - t0} s with "
        f"loading")


def phase_kernel_checks(dev):
    """Every kernel against its plain version, bf16 and f32 pools."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    say("[3] kernels against their plain versions (qwen3-8b heads: Hq=32, "
        "Hkv=8, D=128, bs=16, nb=64)")
    gen = torch.Generator(dev).manual_seed(3)
    errors = {"paged_decode_attention": 0.0, "paged_prefill_attention": 0.0}
    B, n_pages = 4, 4 * NB
    for dtype in (torch.bfloat16, torch.float32):
        for window in (None, 100):
            for read_dtype in (None, torch.bfloat16):
                q, kp, vp = pool_inputs(gen, dtype, n_pages, 1, B)
                bt = shared_tables(gen, B, n_pages)
                lengths = torch.randint(0, NB * BS, (B,), generator=gen,
                                        device=dev, dtype=torch.int32)
                got = pa.paged_attention_cuda(q, kp, vp, bt, lengths, window=window,
                                              read_dtype=read_dtype)
                want = ref.paged_attention_ref(q, kp, vp, bt, lengths, window=window,
                                               read_dtype=read_dtype)
                torch.cuda.synchronize()
                name = (f"decode {str(dtype)[6:]} window={window} "
                        f"read_dtype={str(read_dtype)[6:] if read_dtype else None}")
                err = check_close(name, got, want, *tolerance(dtype, read_dtype))
                errors["paged_decode_attention"] = max(
                    errors["paged_decode_attention"], err)
        for C, window in ((16, None), (128, None), (512, None), (128, 100)):
            B = 2
            q, kp, vp = pool_inputs(gen, dtype, n_pages, C, B)
            bt = shared_tables(gen, B, n_pages)
            base = torch.randint(1, NB * BS - C + 1, (B,), generator=gen,
                                 device=dev, dtype=torch.int32)
            chunk_len = C - 5
            got = pa.paged_prefill_attention_cuda(q, kp, vp, bt, base,
                                                  chunk_len=chunk_len, window=window)
            want = ref.paged_prefill_attention_ref(q, kp, vp, bt, base,
                                                   chunk_len=chunk_len, window=window)
            torch.cuda.synchronize()
            name = (f"prefill {str(dtype)[6:]} C={C} chunk_len={chunk_len} "
                    f"base={base.tolist()} window={window}")
            err = check_close(name, got, want, *tolerance(dtype, None))
            errors["paged_prefill_attention"] = max(
                errors["paged_prefill_attention"], err)
    return errors


def decode_timing_case(gen, prompt_lens):
    """Decode at the main path's shapes: every slot mid-way through its new
    tokens, each slot its own pages, the read_dtype body the engine runs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.kvcache import paged_gather_layer
    dev, dt = gen.device, torch.bfloat16
    n_pages = SLOTS * NB + SLOTS + 1
    q, kp, vp = pool_inputs(gen, dt, n_pages, 1, SLOTS)
    bt = distinct_tables(gen, SLOTS, n_pages)
    lengths = torch.tensor([p + NEW_TOKENS // 2 for p in prompt_lens[:SLOTS]],
                           dtype=torch.int32, device=dev)
    # the library call's input, K/V linearised through the tables (not timed)
    kg, vg = paged_gather_layer(kp, vp, bt)
    col = torch.arange(NB * BS, device=dev)
    mask = (col[None, :] <= lengths[:, None].long())[:, None, None, :]
    return dict(
        shape=f"B={SLOTS} lengths={lengths.tolist()}",
        kernel=lambda: pa.paged_attention_cuda(q, kp, vp, bt, lengths,
                                               read_dtype=dt),
        plain=lambda: ref.paged_attention_ref(q, kp, vp, bt, lengths,
                                              read_dtype=dt),
        library=lambda: F.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask, enable_gqa=True),
        work=decode_work(bt, lengths, None, 2))


def prefill_timing_case(gen):
    """Prefill at the main path's shapes: a full 128-token chunk at base
    256 of one slot's prompt, through the slot's whole table row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.kvcache import paged_gather_layer
    dev, dt = gen.device, torch.bfloat16
    n_pages = SLOTS * NB + SLOTS + 1
    base_pos = 2 * CHUNK
    q, kp, vp = pool_inputs(gen, dt, n_pages, CHUNK, 1)
    bt = distinct_tables(gen, 1, n_pages)
    base = torch.tensor([base_pos], dtype=torch.int32, device=dev)
    # the library call's input, K/V linearised through the tables (not timed)
    kg, vg = paged_gather_layer(kp, vp, bt)
    col = torch.arange(NB * BS, device=dev)
    pos = base_pos + torch.arange(CHUNK, device=dev)
    mask = (col[None, :] <= pos[:, None])[None, None]
    return dict(
        shape=f"B=1 C={CHUNK} chunk_len={CHUNK} base={base_pos}",
        kernel=lambda: pa.paged_prefill_attention_cuda(q, kp, vp, bt, base,
                                                       chunk_len=CHUNK),
        plain=lambda: ref.paged_prefill_attention_ref(q, kp, vp, bt, base,
                                                      chunk_len=CHUNK),
        library=lambda: F.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask, enable_gqa=True),
        work=prefill_work(bt, base, CHUNK, CHUNK, None, 2))


def phase_kernel_times(dev, prompt_lens):
    """Each kernel at the shapes the main path gives it: kernel, plain
    version and library call timed, the bound computed."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    splits, kps = pa.decode_split_plan(SLOTS, HKV, NB, BS, build.sm_count(dev))
    say("[3b] kernel times at the main path's shapes (bf16, median of 20 "
        "calls, L2 flushed before each); decode: grid of "
        f"{splits} splits of {kps} keys x {HKV} KV heads x {SLOTS} sequences, "
        "3 device launches a call (stats pass, value pass, combine)")
    gen = torch.Generator(dev).manual_seed(4)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)  # 256 MB
    rows = {"paged_decode_attention": decode_timing_case(gen, prompt_lens),
            "paged_prefill_attention": prefill_timing_case(gen)}
    out = {}
    for name, r in rows.items():
        err = float((r["kernel"]().float() - r["plain"]().float()).abs().max())
        ms = device_ms(r["kernel"], flush)
        plain_ms = device_ms(r["plain"], flush)
        library_ms = device_ms(r["library"], flush)
        nbytes, ops = r["work"]
        bound_ms, bound_by = bound(nbytes, ops, "bfloat16")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms, bytes=nbytes, ops=ops,
                         shape=r["shape"])
        say(f"  {name} [{r['shape']}]: kernel {ms} ms, plain {plain_ms} ms, "
            f"SDPA on pre-gathered K/V {library_ms} ms, bound {bound_ms} ms "
            f"({bound_by}: {nbytes} B, {ops} ops), kernel/bound "
            f"{ms / bound_ms}, max_abs_err vs plain {err}")
    del flush
    return out


def traffic(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 513, REQUESTS)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def serving_engine(cfg, params, dev, horizon):
    """The main path's engine: slots 4, max_len 1024, block 16, chunk 128,
    both paged kernels pinned, decode horizon ``horizon`` (an int or
    ``"auto"``)."""
    from repro_torch.core import VPE
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine
    return ContinuousBatchingEngine(
        cfg, params, vpe=VPE(), slots=SLOTS, max_len=MAX_LEN, block_size=BS,
        prefill_chunk=CHUNK, decode_horizon=horizon, decode_impl="cuda",
        prefill_kernel="cuda", device=dev)


def serve_traffic(engine, cfg, prompts, label, rid0=0):
    """Serve the traffic on ``engine`` with the launch counts zeroed just
    before and read just after; raise if a gate fails.  Returns the run's
    record.  Decode launches are the decode wrapper's own calls in the run
    plus the calls the graph replays stand for (``replayed_calls``); the
    profiled call of :func:`steady_window` shows that a replay launches the
    kernels."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.runtime.serve_loop import Request, ServeStats
    engine.completed.clear()
    engine.stats = ServeStats()
    graphs = engine.graphs
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    before = (graphs.captures, graphs.replays, graphs.replayed_calls)
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=rid0 + i, prompt=p, max_new_tokens=NEW_TOKENS))
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    captures = graphs.captures - before[0]
    replays = graphs.replays - before[1]
    replayed = graphs.replayed_calls - before[2]
    launches = {"paged_decode_attention": pa.paged_attention_cuda.launches + replayed,
                "paged_prefill_attention": pa.paged_prefill_attention_cuda.launches}
    st = engine.stats
    say(f"  {st.summary()}")
    say(f"  wall {wall} s, {st.decode_steps} decode steps in "
        f"{sum(st.horizon_hist.values())} decode calls (by horizon "
        f"{st.horizon_hist}), {st.prefill_chunks} prefill chunks, TTFT mean "
        f"{st.mean_ttft_s} s max {max(st.ttft_s)} s, decode {st.decode_tok_per_s} "
        f"tok/s, decode wall a step {st.decode_s / st.decode_steps * 1e6} us, "
        f"reserved pages rolled back {st.reserved_pages_rolled_back}, launches "
        f"{launches} (decode: {pa.paged_attention_cuda.launches} wrapper calls, "
        f"{replayed} in {replays} graph replays)")
    say(f"  decode graphs: {graphs.captures} captures ({captures} in the run, "
        f"{st.tainted_steps} calls tainted), graph pool {graphs.pool_bytes()} B")
    if len(done) != len(prompts) or any(r.status != "done" for r in done):
        raise AssertionError(f"{label}: requests not completed: "
                             f"{[(r.rid, r.status, r.error) for r in done]}")
    for r in done:
        if len(r.out) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"{label}: request {r.rid}: tokens {r.out}")
    engine.check_kv()
    if not engine.pages.drained:
        raise AssertionError(f"{label}: page pool not drained after the run")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{label}: {name} was not launched on the main path")
    if replays != sum(st.horizon_hist.values()) \
            or replayed != st.decode_steps * cfg.num_layers:
        raise AssertionError(f"{label}: {replays} replays standing for {replayed} "
                             f"decode calls, for {st.horizon_hist} calls of "
                             f"{st.decode_steps} steps x {cfg.num_layers} layers")
    if launches["paged_prefill_attention"] != st.prefill_chunks * cfg.num_layers:
        raise AssertionError(f"{label}: prefill launches {launches} do not match "
                             f"{st.prefill_chunks} chunks x {cfg.num_layers} layers")
    return dict(
        wall_s=wall, decode_steps=st.decode_steps, prefill_chunks=st.prefill_chunks,
        ttft_s=list(st.ttft_s), decode_tok_per_s=st.decode_tok_per_s,
        decode_us_per_step=st.decode_s / st.decode_steps * 1e6,
        horizon_hist=dict(st.horizon_hist), rolled_back=st.reserved_pages_rolled_back,
        captures=graphs.captures, captures_in_run=captures,
        tainted_steps=st.tainted_steps, graph_pool_bytes=graphs.pool_bytes(),
        launches=launches, layers=cfg.num_layers,
        tokens={r.rid - rid0: r.out for r in done})


def steady_window(engine, cfg, calls):
    """Steady decode on ``engine``, after its timed run: four prompts fill
    every slot, then ``calls`` decode calls run back to back with no
    prefill and no capture, each timed on the host (the whole engine step)
    and on the device (CUDA events around its graph replay) — unprofiled;
    then one more call under torch.profiler, whose device launches of the
    paged decode kernels must be 3 a step a layer (the bf16 ``read_dtype``
    body): the check that a replay really launches them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve_loop import Request
    for i, p in enumerate(traffic(cfg.vocab_size, seed=5)[:SLOTS]):
        engine.submit(Request(rid=1000 + i, prompt=p, max_new_tokens=400))
    while engine.num_decoding < SLOTS:
        engine.step()
    st, graphs = engine.stats, engine.graphs
    spans = []
    run = graphs.run

    def timed(impl, horizon):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(impl, horizon)
        end.record()
        spans.append((start, end))
        return out

    before = (st.decode_steps, st.prefill_chunks, graphs.captures)
    graphs.run = timed
    try:
        t0 = time.perf_counter()
        for _ in range(calls):
            engine.step()
        wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        del graphs.run                      # the bound method again
    torch.cuda.synchronize()
    span_us = sum(a.elapsed_time(b) for a, b in spans) * 1e3
    steps = st.decode_steps - before[0]
    if len(spans) != calls or st.prefill_chunks != before[1] \
            or graphs.captures != before[2]:
        raise AssertionError(f"steady window: {len(spans)} decode calls, "
                             f"{st.prefill_chunks - before[1]} prefill chunks, "
                             f"{graphs.captures - before[2]} captures")
    out = dict(calls=calls, steps=steps, wall_us_per_step=wall_us / steps,
               span_us_per_step=span_us / steps,
               idle_us_per_step=(wall_us - span_us) / steps,
               idle_share=1 - span_us / wall_us)
    steps0 = st.decode_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    profiled_steps = st.decode_steps - steps0
    launches = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                   and kernel_group(e.name) == "paged decode kernels")
    out.update(profiled_steps=profiled_steps, profiled_decode_launches=launches)
    say(f"  steady window (4 slots decoding, unprofiled): {calls} calls, {steps} "
        f"steps, wall {out['wall_us_per_step']} us a step, device span of the "
        f"replays {out['span_us_per_step']} us a step (CUDA events), idle "
        f"{out['idle_us_per_step']} us a step, idle share {out['idle_share']}; one "
        f"profiled call: {profiled_steps} steps, device launches of the paged "
        f"decode kernels {launches} (expected {3 * profiled_steps * cfg.num_layers})")
    if graphs.captures != before[2] or launches != 3 * profiled_steps * cfg.num_layers:
        raise AssertionError(f"profiled replay: {launches} paged decode launches for "
                             f"{profiled_steps} steps x {cfg.num_layers} layers, or "
                             f"it captured")
    return out


def phase_serving(cfg, params, dev, prompts, horizon, label, steady_calls):
    """One serving phase: the engine at ``horizon``, warmed by requests of
    its own (which capture the decode graphs the traffic replays: 32 new
    tokens runs the horizon, 2 runs a single step), the traffic served
    and gated, then the steady window on the same engine.  No capture may
    fall in the timed run."""
    from repro_torch.runtime.serve_loop import Request
    engine = serving_engine(cfg, params, dev, horizon)
    for n in ((NEW_TOKENS, 2) if horizon > 1 else (2,)):
        engine.submit(Request(rid=-1, prompt=np.arange(1, 200, dtype=np.int32),
                              max_new_tokens=n))
        engine.run()
    pool_bytes = sum(t.numel() * t.element_size() for t in engine.page_pool.values())
    say(f"  engine: slots {SLOTS}, max_len {MAX_LEN}, block {BS}, chunk {CHUNK}, "
        f"decode horizon {horizon}, {engine.pages.num_pages} pages + trash, pool "
        f"{pool_bytes} B, {engine.graphs.captures} decode graphs captured in the "
        f"warm-up; traffic: {REQUESTS} requests, prompt lengths "
        f"{[len(p) for p in prompts]}, {NEW_TOKENS} new tokens each")
    run = serve_traffic(engine, cfg, prompts, label)
    if run["captures_in_run"]:
        raise AssertionError(f"{label}: {run['captures_in_run']} captures in the "
                             f"timed run; the warm-up captures every graph it needs")
    if run["launches"]["paged_decode_attention"] != run["decode_steps"] * cfg.num_layers:
        raise AssertionError(f"{label}: decode launches {run['launches']} do not match "
                             f"{run['decode_steps']} decode steps x {cfg.num_layers} layers")
    run["steady"] = steady_window(engine, cfg, steady_calls)
    return run


def phase_main_path(dev):
    """Full-width qwen3-8b, all 36 layers, through the engine, both
    kernels pinned, single decode steps (each a graph replay)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    say(f"[4] main path: {cfg.name}, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.param_count()} params in {cfg.dtype}, "
        f"initialised in {time.perf_counter() - t0} s")
    prompts = traffic(cfg.vocab_size)
    main = phase_serving(cfg, params, dev, prompts, 1, "phase 4", steady_calls=8)
    return cfg, params, prompts, main


def first_difference(label, main, run):
    """Raise unless each request's tokens in ``run`` are phase 4's."""
    differ = [rid for rid, toks in main["tokens"].items() if run["tokens"][rid] != toks]
    say(f"  tokens equal to phase 4's (H = 1), request by request: {not differ}")
    if differ:
        rid = differ[0]
        a, b = main["tokens"][rid], run["tokens"][rid]
        first = next(j for j in range(NEW_TOKENS) if a[j] != b[j])
        raise AssertionError(f"{label}: tokens differ from H = 1 in requests {differ}; "
                             f"request {rid} first at position {first}: {a} / {b}")


def phase_fused_horizons(cfg, params, dev, prompts, main):
    """Phase 4b: phase 4's traffic and engine with ``decode_horizon=16``
    pinned; its tokens must be phase 4's, request by request."""
    say(f"[4b] fused horizons: {cfg.name} at full width, decode_horizon=16, both "
        f"kernels pinned, phase 4's traffic")
    fused = phase_serving(cfg, params, dev, prompts, 16, "phase 4b", steady_calls=2)
    first_difference("phase 4b", main, fused)
    return fused


def phase_auto_horizon(cfg, params, dev, prompts, main, passes=3):
    """Phase 4c: phase 4's traffic, ``passes`` times over, on one engine
    with ``decode_horizon="auto"``: the VPE's ``decode_horizon`` axis
    trials 1, 4 and 16 and keeps one per (queue depth, occupancy) bucket.
    Each pass must give phase 4's tokens; the decisions are printed."""
    say(f"[4c] decode_horizon=auto: {cfg.name} at full width, phase 4's traffic "
        f"{passes} times on one engine")
    engine = serving_engine(cfg, params, dev, "auto")
    out = []
    for k in range(passes):
        run = serve_traffic(engine, cfg, prompts, f"phase 4c pass {k}",
                            rid0=100 * (k + 1))
        first_difference(f"phase 4c pass {k}", main, run)
        run.pop("tokens")
        out.append(run)
    decisions = {}
    say("  decode_horizon decisions (bucket: kept, tried, history):")
    for (op, bucket), d in sorted(engine.vpe.controller._decisions.items(), key=repr):
        if op == "decode_horizon":
            decisions[str(bucket)] = (d.selected, d.tried)
            say(f"    {bucket}: kept {d.selected}, tried {d.tried}, "
                f"{[f'{ev} {v}: {detail}' for ev, v, detail in d.history]}")
    return dict(passes=out, decisions=decisions)


def run_engine(cfg, params, dev, impls, prompts, new_tokens, eos=None, **kw):
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request
    eng = ContinuousBatchingEngine(cfg, params, decode_impl=impls[0],
                                   prefill_kernel=impls[1], device=dev, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens, eos_id=eos))
    done = eng.run()
    eng.check_kv()
    if not eng.pages.drained:
        raise AssertionError("page pool not drained")
    return {r.rid: r.out for r in done}


def phase_reduced_parity(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    cfg = get_config("qwen3-8b").reduced()
    params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(1))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 60, 6)]
    kw = dict(slots=3, max_len=96, block_size=BS, prefill_chunk=16)
    gather = run_engine(cfg, params, dev, ("grouped", "gather"), prompts, 12, **kw)
    kernels = run_engine(cfg, params, dev, ("cuda", "cuda"), prompts, 12, **kw)
    say(f"[5a] reduced {cfg.name} ({cfg.dtype}): greedy tokens, (grouped, "
        f"gather) == (cuda, cuda): {gather == kernels}")
    if gather != kernels:
        raise AssertionError(f"tokens differ:\n gather {gather}\n kernels {kernels}")
    # fused horizons against single steps, both decode variants; then an EOS
    # whose first occurrence in request 0 is its fifth token or later, so it
    # stops a horizon midway: each request's tokens end at its first EOS
    ref0 = gather[0]
    eos = next(t for i, t in enumerate(ref0) if i >= 4 and t not in ref0[:i])
    want_eos = {rid: out[:out.index(eos) + 1] if eos in out else out
                for rid, out in gather.items()}
    for impls in (("grouped", "gather"), ("cuda", "cuda")):
        for horizon in (4, 16):
            fused = run_engine(cfg, params, dev, impls, prompts, 12,
                               decode_horizon=horizon, **kw)
            say(f"  {impls} H={horizon} tokens == H=1: {fused == gather}")
            if fused != gather:
                raise AssertionError(f"{impls} H={horizon} tokens differ:\n H=1 "
                                     f"{gather}\n fused {fused}")
        got = run_engine(cfg, params, dev, impls, prompts, 12, eos=eos,
                         decode_horizon=16, **kw)
        say(f"  {impls} H=16 with EOS {eos} (request 0's token "
            f"{ref0.index(eos)}): tokens end at the first EOS: {got == want_eos}")
        if got != want_eos:
            raise AssertionError(f"{impls} EOS run: {got} != {want_eos}")


def first_step_logits(cfg, params, dev, prompts, kernel, decode_impl, tokens=None):
    """Prefill each prompt in 128-token chunks into its own pages, then one
    decode step for all; returns (prefill logits (B, V), decode logits
    (B, V))."""
    import torch
    from repro_torch.core import pad_to_bucket
    from repro_torch.models import model as model_lib
    B = len(prompts)
    n_pages = B * NB
    pool = model_lib.init_page_pool(cfg, n_pages, BS, dev)
    cache = model_lib.init_paged_cache(cfg, B, MAX_LEN, BS, n_pages, dev)
    logits = []
    for b, p in enumerate(prompts):
        n = -(-(len(p) + 1) // BS)
        cache["bt"][b, :n] = torch.arange(b * NB, b * NB + n, dtype=torch.int32,
                                          device=dev)
        row = cache["bt"][b].contiguous()
        for base in range(0, len(p), CHUNK):
            clen = min(CHUNK, len(p) - base)
            toks = np.zeros((1, pad_to_bucket(clen, minimum=16)), np.int32)
            toks[0, :clen] = p[base:base + clen]
            pool, lg = model_lib.prefill_chunk_paged(
                cfg, params, pool, row, torch.from_numpy(toks).to(dev), base,
                clen, kernel=kernel)
        logits.append(lg[0])
        cache["length"][b] = len(p)
    pre = torch.stack(logits)
    if tokens is None:
        tokens = torch.argmax(pre, dim=-1).to(torch.int32)
    live = torch.ones((B,), dtype=torch.int32, device=dev)
    pool, cache, dec = model_lib.decode_step_paged(
        cfg, params, pool, cache, tokens[:, None], live, decode_impl=decode_impl)
    return pre, dec[:, 0], tokens


def phase_full_width_parity(cfg, params, dev, prompts, atol):
    import torch
    ref_pre, ref_dec, toks = first_step_logits(cfg, params, dev, prompts,
                                               "gather", "grouped")
    got_pre, got_dec, _ = first_step_logits(cfg, params, dev, prompts, "cuda",
                                            "cuda", tokens=toks)
    torch.cuda.synchronize()
    out = {}
    for what, want, got in (("prefill", ref_pre, got_pre), ("decode", ref_dec, got_dec)):
        if not (torch.isfinite(want).all() and torch.isfinite(got).all()):
            raise AssertionError(f"{what} logits are not finite")
        err = float((got - want).abs().max())
        same = torch.argmax(got, -1) == torch.argmax(want, -1)
        top2 = torch.topk(want, 2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).tolist()
        say(f"[5b] full width bf16 {what} logits, cuda vs gather: max abs diff "
            f"{err} (tolerance {atol}), logit scale {float(want.abs().max())}, "
            f"argmax equal {same.tolist()}, reference top-2 margins {margins}")
        if not bool(same.all()):
            b = int((~same).nonzero()[0])
            say(f"  first sequence whose argmax differs: {b}, reference top-2 "
                f"margin {margins[b]}")
        if err > atol:
            raise AssertionError(f"{what} logits differ by {err} > {atol}")
        out[what] = dict(max_abs_diff=err, argmax_equal=same.tolist(),
                         top2_margin=margins)
    return out


# kernel-name groups of a trace, first match wins (lower-case keys)
KERNEL_GROUPS = (("paged decode kernels", ("paged_decode",)),
                 ("paged prefill kernel", ("paged_prefill_kernel",)),
                 ("flash forward kernel", ("flash_fwd_kernel",)),
                 ("f32 GEMMs", ("f32f32", "sgemm")),
                 ("other GEMMs", ("nvjet", "gemm", "xmma")),
                 ("softmax", ("softmax",)),
                 ("memcpy/memset", ("memcpy", "memset")))


def kernel_group(name):
    name = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other elementwise/reduction"


def profiled(fn, label, trace_dir, ranges=()):
    """Run ``fn`` under torch.profiler; print its wall, the device's busy
    share of it, the device time by kernel and by kernel group, and the
    span on the device timeline of each named ``record_function`` range
    (summed over its occurrences).  Returns a summary."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, decode_spans = {}, []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue                    # a range's span, not a kernel
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
            if kernel_group(e.name) == "paged decode kernels":
                decode_spans.append((e.time_range.start, e.time_range.end))
    # decode kernels that start before the one ahead of them ends: the
    # programmatic dependent launches (value pass, combine) overlapping
    decode_spans.sort()
    overlaps = sum(1 for (_, end), (start, _) in zip(decode_spans, decode_spans[1:])
                   if start < end)
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    say(f"  trace {label}: wall {wall_us} us, device busy {busy_us} us "
        f"({busy_us / wall_us} of the wall; idle share {1 - busy_us / wall_us}), "
        f"{sum(n for n, _ in by_name.values())} device events")
    for name, (n, us) in top:
        say(f"    {us} us in {n} calls ({us / busy_us if busy_us else 0} of busy): "
            f"{name[:100]}")
    groups = {}
    for name, (n, us) in by_name.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + us
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        say(f"    group {group}: {us} us ({us / busy_us if busy_us else 0} of busy)")
    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / f"trace_{label}.json.gz"
    prof.export_chrome_trace(str(path))
    # a range's span on the device timeline, summed over its occurrences
    in_range = {r: 0.0 for r in ranges}
    if ranges:
        with gzip.open(path, "rt") as f:
            for e in json.load(f)["traceEvents"]:
                if e.get("cat") == "gpu_user_annotation" and e.get("name") in in_range:
                    in_range[e["name"]] += e["dur"]
    for name, us in in_range.items():
        say(f"    range {name}: {us} us on the device timeline "
            f"({us / busy_us if busy_us else 0} of busy)")
    counts = {}
    for name, (n, _) in by_name.items():
        counts[kernel_group(name)] = counts.get(kernel_group(name), 0) + n
    return dict(wall_us=wall_us, busy_us=busy_us, ranges=in_range, groups=groups,
                counts=counts, decode_overlaps=overlaps,
                top=[(name, n, us) for name, (n, us) in top])


def phase_trace(cfg, params, dev, trace_dir):
    """Where the main path's time goes: a profiler window over 8 steady
    single decode steps at 4 busy slots, one over a steady fused horizon of
    16 steps, and one over a 512-token prompt's four prefill chunks: the
    breakdown by kernel.  Its walls and idle shares hold the profiler's own
    cost (the unprofiled idle time is phase 4's steady window).  The device
    launches of the decode kernels must be 3 per step per layer, as in the
    profiled call of phases 4 and 4b."""
    from repro_torch.core import VPE
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request
    kw = dict(slots=SLOTS, max_len=MAX_LEN, block_size=BS, prefill_chunk=CHUNK,
              decode_impl="cuda", prefill_kernel="cuda", device=dev, vpe=VPE())
    prompts = traffic(cfg.vocab_size, seed=5)
    say("[6] traces (torch.profiler)")
    out = {}
    for horizon, steps, new_tokens in ((1, 8, NEW_TOKENS), (16, 1, 400)):
        eng = ContinuousBatchingEngine(cfg, params, decode_horizon=horizon, **kw)
        for i, p in enumerate(prompts[:SLOTS]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
        while eng.num_decoding < SLOTS:
            eng.step()
        st = eng.stats
        before = (st.decode_steps, eng.graphs.captures, st.horizon_calls)
        label = f"decode_{steps}_steps" if horizon == 1 else "decode_horizon_16"
        r = profiled(lambda: [eng.step() for _ in range(steps)], label, trace_dir)
        decode_steps = st.decode_steps - before[0]
        launches = r["counts"].get("paged decode kernels", 0)
        r.update(decode_steps=decode_steps, horizon=horizon, decode_launches=launches,
                 profiled_idle_us_per_step=(r["wall_us"] - r["busy_us"]) / decode_steps,
                 wall_us_per_step=r["wall_us"] / decode_steps)
        say(f"  {label}: {decode_steps} decode steps in {steps} calls, device "
            f"launches of the paged decode kernels {launches} (expected "
            f"{3 * decode_steps * cfg.num_layers}; {r['decode_overlaps']} start before "
            f"the one ahead of them ends), captures in the window "
            f"{eng.graphs.captures - before[1]}, idle us a step (profiled) "
            f"{r['profiled_idle_us_per_step']}, wall us a step {r['wall_us_per_step']}")
        if decode_steps != horizon * steps or eng.graphs.captures != before[1] \
                or st.horizon_calls - before[2] != (steps if horizon > 1 else 0):
            raise AssertionError(f"{label}: the window was not {steps} steady "
                                 f"replays of H={horizon}")
        if launches != 3 * decode_steps * cfg.num_layers:
            raise AssertionError(f"{label}: {launches} paged decode launches in the "
                                 f"trace, expected 3 x {decode_steps} x "
                                 f"{cfg.num_layers}")
        out[label] = r
        del eng
    eng = ContinuousBatchingEngine(cfg, params, **kw)
    eng.submit(Request(rid=0, prompt=np.resize(prompts[0], 4 * CHUNK),
                       max_new_tokens=2))
    out["prefill"] = profiled(lambda: [eng.step() for _ in range(4)],
                              "prefill_4_chunks", trace_dir)
    return out

# -- the training path ------------------------------------------------------------------

def flash_inputs(gen, dtype, Hq, Hkv, S, T, D):
    import torch
    dev = gen.device
    return (torch.randn((1, Hq, S, D), generator=gen, device=dev).to(dtype),
            torch.randn((1, Hkv, T, D), generator=gen, device=dev).to(dtype),
            torch.randn((1, Hkv, T, D), generator=gen, device=dev).to(dtype))


def phase_flash_checks(dev):
    """The flash kernel against its plain version: bf16 and f32, danube and
    qwen3 heads, causal on and off, window none / 1024 / 4096, S = T and
    S < T, T off the tile; then the gradient of ``attention_flash`` (kernel
    forward) against autograd through ``attention_chunked``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import layers
    say("[3c] flash kernel against its plain version (B=1)")
    gen = torch.Generator(dev).manual_seed(6)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for Hq, Hkv, D in FLASH_HEADS:
            for S, T, causal, window in FLASH_CASES:
                q, k, v = flash_inputs(gen, dtype, Hq, Hkv, S, T, D)
                got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
                want = ref.attention_ref(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                name = (f"flash {str(dtype)[6:]} Hq={Hq} Hkv={Hkv} D={D} S={S} "
                        f"T={T} causal={causal} window={window}")
                err = max(err, check_close(name, got, want, *flash_tolerance(dtype)))
                del q, k, v, got, want
    # the autograd wiring of attention_flash: kernel forward, and a backward
    # that is attention_chunked's VJP on both sides, so the gradients agree
    # exactly and test the wiring, not the kernel; the forward outputs
    # differ by the kernel's sums (f32: the same sums in another order)
    Hq, Hkv, D = FLASH_HEADS[0]
    q, k, v = (t.requires_grad_() for t in
               flash_inputs(gen, torch.float32, Hq, Hkv, 1024, 1024, D))
    g = torch.randn(q.shape, generator=gen, device=dev)
    outs = {}
    for name, fn in (("flash_cuda", layers.attention_flash),
                     ("reference", layers.attention_chunked)):
        o = fn(q, k, v, causal=True, window=512)
        outs[name] = (o.detach(), *torch.autograd.grad(o, (q, k, v), g))
    torch.cuda.synchronize()
    for i, what in enumerate(("out", "dq", "dk", "dv")):
        err = max(err, check_close(f"attention_flash vs attention_chunked f32 {what} "
                                   f"(Hq={Hq} Hkv={Hkv} D={D} S=T=1024 window=512)",
                                   outs["flash_cuda"][i], outs["reference"][i],
                                   *flash_tolerance(torch.float32)))
    return err


def flash_work(S, T, Hq, Hkv, D, causal, window, elem):
    """(bytes, ops) of forward attention on these shapes: q, k, v read once,
    the output written; 4*D ops per (query head, valid column) — the two
    products, each 2*D per pair."""
    pairs = 0
    for s in range(S):
        row = s + T - S
        hi = min(row, T - 1) if causal else T - 1
        lo = max(0, row - window + 1) if window is not None else 0
        pairs += max(0, hi - lo + 1)
    nbytes = (2 * Hq * S * D + 2 * Hkv * T * D) * elem
    return nbytes, 4 * D * Hq * pairs


def phase_flash_time(dev, cfg):
    """The flash kernel at the training path's shapes, bf16: checked against
    its plain version; kernel, plain version and one SDPA call
    (``is_causal``; the window is no narrower than the sequence) timed with
    L2 flushed; the bound computed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    S = T = TRAIN_SEQ
    Hq, Hkv, D, window = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.window
    if window is not None and window < S:
        raise AssertionError("the SDPA yardstick assumes the window spans the sequence")
    gen = torch.Generator(dev).manual_seed(7)
    q, k, v = flash_inputs(gen, torch.bfloat16, Hq, Hkv, S, T, D)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    kernel = lambda: fa.flash_attention_cuda(q, k, v, causal=True, window=window)  # noqa: E731
    plain = lambda: ref.attention_ref(q, k, v, causal=True, window=window)  # noqa: E731
    shape = f"B=1 Hq={Hq} Hkv={Hkv} S=T={S} D={D} causal window={window} bf16"
    err = check_close(f"flash_attention [{shape}]", kernel(), plain(),
                      *flash_tolerance(torch.bfloat16))
    ms = device_ms(kernel, flush)
    plain_ms = device_ms(plain, flush)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), flush)
    nbytes, ops = flash_work(S, T, Hq, Hkv, D, True, window, 2)
    bound_ms, bound_by = bound(nbytes, ops, "bfloat16")
    say(f"  flash_attention [{shape}]: kernel {ms} ms, plain {plain_ms} ms, "
        f"SDPA {library_ms} ms, bound {bound_ms} ms ({bound_by}: {nbytes} B, "
        f"{ops} ops), kernel/bound {ms / bound_ms}, max_abs_err vs plain {err}")
    del flush
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, bytes=nbytes, ops=ops,
                shape=shape)


def train_flops(cfg, n_params, tokens):
    """Model FLOPs of one step: 6 * params * tokens for the weights, and
    12 * D * Hq per (query, valid column) pair per layer for attention
    (two products forward, twice that backward; no recomputation)."""
    pairs = flash_work(TRAIN_SEQ, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, True, cfg.window, 2)[1] // (4 * cfg.head_dim
                                                                 * cfg.num_heads)
    attn = 12 * cfg.head_dim * cfg.num_heads * pairs * cfg.num_layers * TRAIN_BATCH
    return 6 * n_params * tokens + attn, attn


def bit_sums(tree, key: str = "") -> dict:
    """{leaf key: the sum of its elements' bit patterns as int64}: exact,
    so a leaf that differs in any one element differs here."""
    import torch
    if isinstance(tree, dict):
        return {k2: n for k in tree for k2, n in bit_sums(tree[k], f"{key}[{k!r}]").items()}
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int32: torch.int32}
    flat = tree.detach().reshape(-1).view(ints[tree.dtype])
    return {key: sum(int(c.to(torch.int64).sum()) for c in flat.split(1 << 26))}


def phase_train(dev, trace_dir):
    """Full h2o-danube-3-4b trained by TrainLoop: the VPE trial, then
    ``flash_cuda`` pinned with the launch count read, then a full-size
    checkpoint round trip."""
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.train_loop import (STATIC_BUCKET, TrainLoop,
                                                TrainLoopConfig)
    cfg = get_config(TRAIN_ARCH)
    n_params = cfg.param_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=0))
    loop = TrainLoop(cfg, TrainLoopConfig(total_steps=1000, warmup_steps=100,
                                          log_every=0),
                     data, seed=0, device=dev)
    torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size() for t in
                      torch.utils._pytree.tree_leaves((loop.params, loop.opt_state)))
    say(f"[7] training path: {cfg.name}, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, window {cfg.window}, {n_params} params in {cfg.dtype} "
        f"(f32 master, m, v), remat {cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens; state {state_bytes} B on the card, set up in "
        f"{time.perf_counter() - t0} s")

    # the VPE free: the reference until it has 3 steady samples, then a
    # 3-step trial of flash_cuda, then its decision
    decision = loop.vpe.controller.decision("attn_impl", STATIC_BUCKET)
    while not any(e in ("switch", "revert") for e, _, _ in decision.history):
        if loop.step >= 12:
            raise AssertionError(f"no attn_impl decision after {loop.step} steps")
        impl = loop.tuner.current()["attn_impl"]
        m = loop.run(loop.step + 1)[-1]
        say(f"  step {loop.step} [{impl}]: loss {m['loss']}, {m['step_time_s']} s")
    say(f"  {loop.vpe.report()}")
    selected = decision.selected

    # flash_cuda pinned: the counted steps
    loop.vpe.controller.force("attn_impl", STATIC_BUCKET, "flash_cuda",
                              reason="chip_smoke counts the kernel's launches")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    first = loop.step
    metrics = loop.run(first + TRAIN_STEPS)[-TRAIN_STEPS:]
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    expected = 2 * cfg.num_layers * TRAIN_STEPS
    losses = [m["loss"] for m in metrics]
    secs = [m["step_time_s"] for m in metrics]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, attn_flops = train_flops(cfg, n_params, tokens)
    step_s = float(np.median(secs))
    say(f"  flash_cuda pinned, steps {first + 1}..{loop.step}: losses {losses}, "
        f"step seconds {secs}; median {step_s} s, {tokens / step_s} tokens/s; "
        f"model FLOPs {flops} per step ({attn_flops} of them attention) -> "
        f"{flops / step_s / PEAK_OPS_PER_S['bfloat16']} of 989 TFLOP/s; peak "
        f"memory {peak} B ({peak / 2 ** 30} GiB); flash launches {launches} "
        f"(expected {expected}: 2 per layer per step under remat)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if launches != expected:
        raise AssertionError(f"flash launches {launches} != {expected}")

    traces = None
    if trace_dir:
        batch = data.batch_at(loop.step)
        say("[7b] trace of one training step (torch.profiler)")
        traces = profiled(lambda: loop.run_step(batch), "train_step", trace_dir,
                          ranges=("train_step.loss_and_grads", "train_step.optimizer",
                                  "attention_flash.backward"))

    # full-size checkpoint round trip of the bf16 params, the f32 master
    # copy and the step, through the checkpoint module TrainLoop.save and
    # restore use: every leaf zeroed before the restore, and compared bit
    # for bit (bit_sums) with what was saved.  m and v stay out: the whole
    # state (state_bytes) would pass the 45 GiB this script may write to
    # disk in one run; the loop's own save/restore of every leaf is checked
    # at reduced size (tests).
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tree = {"params": loop.params,
                "opt": {k: loop.opt_state[k] for k in ("master", "step")}}
        step = loop.step
        saved = bit_sums(tree)
        t0 = time.perf_counter()
        ckpt.save(ckpt_dir, step, tree, extra={"step": step})
        save_s = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*") if f.is_file())
        loss_a = loop.run_step(data.batch_at(step))["loss"]
        for leaf in torch.utils._pytree.tree_leaves(tree):
            leaf.zero_()
        t0 = time.perf_counter()
        ckpt.restore(ckpt_dir, tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored = bit_sums(tree)
        loss_b = loop.run_step(data.batch_at(step))["loss"]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    differ = [k for k in saved if restored[k] != saved[k]]
    say(f"  checkpoint of the params, the f32 master and the step at step "
        f"{step}: {len(saved)} leaves, {on_disk} B on disk, save {save_s} s, "
        f"restore {restore_s} s; leaves zeroed before the restore and differing "
        f"bitwise after it: {len(differ)}; loss of step {step + 1} {loss_a} "
        f"without and {loss_b} after the restore")
    if differ:
        raise AssertionError(f"restored leaves differ from the saved: {differ}")
    if loss_a != loss_b:
        raise AssertionError(f"loss after restore {loss_b} != {loss_a}")
    out = dict(params=n_params, state_bytes=state_bytes, vpe_selected=selected,
               vpe_report=loop.vpe.report(), losses=losses, step_s=secs,
               tokens_per_s=tokens / step_s, flops=flops,
               mfu=flops / step_s / PEAK_OPS_PER_S["bfloat16"], peak_bytes=peak,
               launches=launches, ckpt_bytes=on_disk, save_s=save_s,
               restore_s=restore_s, trace=traces)
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_parity(dev):
    """Reduced h2o-danube-3-4b in f32 on the card: loss and gradients, and
    three TrainLoop steps, of flash_cuda against reference (f32: the same
    sums in another order; losses within 1e-5, gradients within 1e-4)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
    base = get_config(TRAIN_ARCH).reduced()
    params = model_lib.init_params(base, torch.Generator(dev).manual_seed(2))
    data = DataConfig(vocab_size=base.vocab_size, seq_len=64, global_batch=2, seed=3)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticStream(data).batch_at(0).items()}
    out = {}
    for impl in ("flash_cuda", "reference"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        leaves, spec = torch.utils._pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        loss = model_lib.loss_fn(cfg, torch.utils._pytree.tree_unflatten(leaves, spec),
                                 batch)
        grads = torch.autograd.grad(loss, leaves)
        lc = TrainLoopConfig(total_steps=3, warmup_steps=1, log_every=0,
                             enable_vpe=False)
        loop = TrainLoop(cfg, lc, SyntheticStream(data), device=dev,
                         params=torch.utils._pytree.tree_map(torch.clone, params))
        out[impl] = (float(loss.detach()), grads, [m["loss"] for m in loop.run()])
    gerr = max(float((a - b).abs().max()) for a, b in
               zip(out["flash_cuda"][1], out["reference"][1]))
    lerr = max(abs(a - b) / abs(b) for a, b in
               zip([out["flash_cuda"][0], *out["flash_cuda"][2]],
                   [out["reference"][0], *out["reference"][2]]))
    say(f"[8] reduced {base.name} f32 (seq 64, window {base.window}): flash_cuda "
        f"vs reference loss {out['flash_cuda'][0]} / {out['reference'][0]}, "
        f"loop losses {out['flash_cuda'][2]} / {out['reference'][2]}; worst "
        f"relative loss difference {lerr} (tolerance 1e-5), worst gradient "
        f"difference {gerr} (tolerance 1e-4)")
    if lerr > 1e-5 or gerr > 1e-4:
        raise AssertionError("flash_cuda and reference disagree on the reduced model")
    return dict(loss_rel_err=lerr, grad_err=gerr)


# -- the paper path -----------------------------------------------------------------

def phase_paper_kernel_checks(dev):
    """matmul and conv2d against their plain versions on the card, f32 and
    bf16; the bf16 kernels also against the f32 kernel on the widened
    inputs, rounded to bf16, bit for bit (the same sums in the same order,
    rounded once).  Returns the worst error per kernel and dtype."""
    import torch
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ref
    say("[9] paper-path kernels against their plain versions")
    gen = torch.Generator(dev).manual_seed(9)
    errors = {"matmul": {}, "conv2d": {}}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        for m, k, n in MATMUL_CHECKS:
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            got = kmm.matmul(a, b)
            err = check_close(f"matmul {dname} {m}x{k}x{n}", got, ref.matmul_ref(a, b),
                              *matmul_tolerance(dtype, k))
            if dtype == torch.bfloat16 and not torch.equal(
                    got, kmm.matmul(a.float(), b.float()).to(dtype)):
                raise AssertionError(f"matmul bf16 {m}x{k}x{n}: not the f32 sums "
                                     f"rounded once")
            errors["matmul"][dname] = max(errors["matmul"].get(dname, 0.0), err)
        for h, w, k in CONV_CHECKS:
            x = torch.randn((h, w), generator=gen, device=dev).to(dtype)
            taps = torch.randn((k, k), generator=gen, device=dev).to(dtype)
            got = kconv.conv2d(x, taps)
            if got.shape != (h - k + 1, w - k + 1):
                raise AssertionError(f"conv2d {h}x{w}*{k}x{k}: shape {tuple(got.shape)}")
            err = check_close(f"conv2d {dname} {h}x{w} * {k}x{k}", got,
                              ref.conv2d_ref(x, taps), *conv_tolerance(dtype))
            if dtype == torch.bfloat16 and not torch.equal(
                    got, kconv.conv2d(x.float(), taps.float()).to(dtype)):
                raise AssertionError(f"conv2d bf16 {h}x{w}*{k}x{k}: not the f32 sums "
                                     f"rounded once")
            errors["conv2d"][dname] = max(errors["conv2d"].get(dname, 0.0), err)
    torch.cuda.synchronize()
    say(f"  worst errors: {errors}")
    return errors


def phase_paper_kernel_times(dev):
    """matmul and conv2d at the paper path's shapes, f32: kernel, plain
    version and one library call (``torch.matmul``, ``F.conv2d``, both with
    TF32 off; timed only, never called by the port) timed with L2 flushed,
    the bound computed.  Keys "matmul" and "conv2d" hold the Table-1
    shapes (512^3; 512^2 * 5x5)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ref
    say("[10] paper-path kernel times (f32, median of 20 calls, L2 flushed before "
        "each)")
    gen = torch.Generator(dev).manual_seed(10)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    out = {}
    for m in (512, 4096):
        a = torch.randn((m, m), generator=gen, device=dev)
        b = torch.randn((m, m), generator=gen, device=dev)

        def library(a=a, b=b):
            with ref.full_f32():
                return torch.matmul(a, b)
        out[f"matmul {m}^3"] = dict(
            name="matmul", kernel=lambda a=a, b=b: kmm.matmul(a, b),
            plain=lambda a=a, b=b: ref.matmul_ref(a, b), library=library,
            tol=matmul_tolerance(torch.float32, m),
            work=(3 * m * m * 4, 2 * m ** 3))
    for hw, k in ((512, 5), (384, 3)):
        x = torch.randn((hw, hw), generator=gen, device=dev)
        taps = torch.randn((k, k), generator=gen, device=dev)

        def library(x=x, taps=taps):
            with ref.full_f32():
                return F.conv2d(x[None, None], taps[None, None])[0, 0]
        o = hw - k + 1
        out[f"conv2d {hw}^2 * {k}x{k}"] = dict(
            name="conv2d", kernel=lambda x=x, taps=taps: kconv.conv2d(x, taps),
            plain=lambda x=x, taps=taps: ref.conv2d_ref(x, taps), library=library,
            tol=conv_tolerance(torch.float32),
            work=((hw * hw + k * k + o * o) * 4, 2 * k * k * o * o))
    times = {}
    for shape, r in out.items():
        err = check_close(f"{shape} f32", r["kernel"](), r["plain"](), *r["tol"])
        ms = device_ms(r["kernel"], flush)
        plain_ms = device_ms(r["plain"], flush)
        library_ms = device_ms(r["library"], flush)
        nbytes, ops = r["work"]
        bound_ms, bound_by = bound(nbytes, ops, "float32")
        times[shape] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                            bytes=nbytes, ops=ops, shape=shape)
        say(f"  {shape}: kernel {ms} ms, plain {plain_ms} ms, library {library_ms} ms, "
            f"bound {bound_ms} ms ({bound_by}: {nbytes} B, {ops} ops), kernel/bound "
            f"{ms / bound_ms}, kernel/library {ms / library_ms}")
    times["matmul"] = times["matmul 512^3"]
    times["conv2d"] = times["conv2d 512^2 * 5x5"]
    # the launch floor: one kernel that does nearly nothing (a one-element
    # fill), timed as the kernels above are
    one = torch.empty(1, device=dev)
    times["launch floor"] = device_ms(lambda: one.fill_(1.0), flush)
    say(f"  launch floor (a one-element fill, timed as above): "
        f"{times['launch floor']} ms")
    del flush
    return times


def paper_launches():
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import matmul as kmm
    return {"matmul": kmm.matmul.launches, "conv2d": kconv.conv2d.launches}


def launches_since(before):
    return {k: n - before[k] for k, n in paper_launches().items()}


def phase_table1(dev):
    """Table 1 (benchmarks/table1.py's loop): the six algorithms at the
    paper's sizes (scale 1.0) under a fresh VPE, 12 calls each.  Returns
    the rows and, for the output checks, each algorithm's inputs and its
    last output (under the VPE's final decision)."""
    from repro_torch.bench_algos import ALGORITHMS, build_vpe, make_inputs
    from repro_torch.core import shape_bucket
    vpe, fns = build_vpe(device=dev)
    before = paper_launches()
    rows, outputs = [], {}
    for name, algo in ALGORITHMS.items():
        args = make_inputs(name, scale=1.0, device=dev)
        for _ in range(TABLE1_CALLS):
            out = fns[name](*args)
        bucket = shape_bucket(*args)
        decided = vpe.controller.selected(name, bucket)
        means = {v: vpe.profiler.mean(name, v, bucket)
                 for v in vpe.registry.op(name).variant_names()}
        steady = {v: vpe.profiler.samples(name, v, bucket).steady.n for v in means}
        naive_ms = means["reference"] * 1e3
        vpe_ms = (means[decided] or means["reference"]) * 1e3
        row = dict(name=name, shapes=[tuple(a.shape) for a in args], naive_ms=naive_ms,
                   vpe_ms=vpe_ms, speedup=naive_ms / vpe_ms,
                   paper_speedup=algo.paper_speedup, decision=decided,
                   variant_ms={v: (m * 1e3 if m is not None else None)
                               for v, m in means.items()},
                   steady_samples=steady,
                   trials=[f"{e}:{v}:{d}" for e, v, d in
                           vpe.controller.decision(name, bucket).history])
        rows.append(row)
        outputs[name] = (args, out, decided)
        say(f"  {name} {row['shapes']}: naive {naive_ms} ms, VPE {vpe_ms} ms, "
            f"speedup {row['speedup']} (paper {algo.paper_speedup}), decision "
            f"{decided}; variant ms {row['variant_ms']}; steady samples {steady}; "
            f"trials {row['trials']}")
        if "cuda" in means and steady["cuda"] < 1:
            raise AssertionError(f"{name}: the cuda variant has no steady sample")
    launches = launches_since(before)
    say(f"  launches in the call loops: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"Table 1 launched no {name} kernel")
    return rows, outputs, vpe, fns


def phase_sweep(dev):
    """Fig. 2b (benchmarks/fig2b.py's loop) on the card: per size, each
    matmul variant timed on the host clock around fenced calls (one warm-up,
    mean of 3), then 10 calls through the VPE to learn the size's bucket.
    Returns the rows, the crossovers and the inputs (for the checks)."""
    import torch
    from repro_torch.bench_algos import build_vpe
    from repro_torch.core import block_until_ready, shape_bucket
    vpe, fns = build_vpe(device=dev)
    entry = vpe.registry.op("matmul")
    rng = np.random.default_rng(0)
    rows, inputs = [], {}

    def host_s(fn, a, b):
        block_until_ready(fn(a, b))
        t0 = time.perf_counter()
        for _ in range(SWEEP_REPS):
            block_until_ready(fn(a, b))
        return (time.perf_counter() - t0) / SWEEP_REPS

    for n in SWEEP:
        a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dev)
        ms = {v: host_s(entry.variants[v].fn, a, b) * 1e3 for v in entry.variant_names()}
        for _ in range(SWEEP_CALLS):
            fns["matmul"](a, b)
        decision = vpe.controller.decision("matmul", shape_bucket(a, b))
        row = dict(n=n, ms=ms, winner=min(ms, key=ms.get), vpe_decision=decision.selected,
                   trials=[f"{e}:{v}:{d}" for e, v, d in decision.history])
        rows.append(row)
        inputs[n] = (a, b)
        say(f"  n={n}: ms {ms}, winner {row['winner']}, VPE {row['vpe_decision']}; "
            f"trials {row['trials']}")
    cross = {}
    for fast, slow in (("fused", "reference"), ("cuda", "reference"), ("cuda", "fused")):
        wins = [r["n"] for r in rows if r["ms"][fast] < r["ms"][slow]]
        cross[f"{fast}<{slow}"] = wins[0] if wins else None
    say(f"  crossover (first size where the first variant is faster): {cross} "
        f"(paper: ~75 for the DSP against the ARM core)")
    return rows, cross, inputs


def phase_paper_path(dev):
    """Phase 11: Table 1, the Fig. 2b sweep, the image pipeline and the
    quickstart, with the matmul and conv2d launch counts zeroed just before
    and read just after; then the outputs checked (those launches are not
    counted)."""
    import torch
    from repro_torch.examples import image_pipeline, quickstart
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ref
    torch.cuda.synchronize()
    kmm.reset_launch_counts()
    kconv.reset_launch_counts()
    say("[11a] Table 1: the six algorithms at the paper's sizes under the VPE "
        f"({TABLE1_CALLS} calls each)")
    t0 = time.perf_counter()
    rows, outputs, vpe, fns = phase_table1(dev)
    split = {"table1": paper_launches()}
    say(f"[11b] Fig. 2b: matmul sweep {SWEEP}, each variant timed (host clock, "
        f"fenced, mean of {SWEEP_REPS} after a warm-up), {SWEEP_CALLS} VPE calls per size")
    sweep, crossover, sweep_inputs = phase_sweep(dev)
    split["sweep"] = launches_since(split["table1"])
    say("[11c] image pipeline (repro_torch.examples.image_pipeline, 384^2 frames, "
        "grant at frame 24)")
    mark = paper_launches()
    pipeline = image_pipeline.main(device=dev)
    split["image_pipeline"] = launches_since(mark)
    events = [(e, v) for e, v, _ in pipeline["history"]]
    for v in ("fused", "cuda"):
        if ("trial", v) not in events or not (("switch", v) in events
                                              or ("revert", v) in events):
            raise AssertionError(f"image pipeline: no concluded {v} trial: {events}")
    if not all(np.isfinite(pipeline["fps_trace"])):
        raise AssertionError("image pipeline: non-finite fps")
    say(f"  fps before {pipeline['fps_before']}, after {pipeline['fps_after']}, ratio "
        f"{pipeline['ratio']}, decision {pipeline['decision']}, conv launches "
        f"{split['image_pipeline']['conv2d']}")
    say("[11d] quickstart (repro_torch.examples.quickstart)")
    mark = paper_launches()
    quick = quickstart.main(device=dev)
    split["quickstart"] = launches_since(mark)
    torch.cuda.synchronize()
    launches = paper_launches()
    wall = time.perf_counter() - t0
    say(f"  paper path: {wall} s, launches {launches} (by part {split})")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the paper path")
    for what in ("smooth", "bench"):
        if "trial" not in quick[what] or ("switch" not in quick[what]
                                          and "revert" not in quick[what]):
            raise AssertionError(f"quickstart {what}: no concluded trial")

    say("[11e] outputs: under the VPE's decision against the reference variant "
        "(integers equal, floats within 2e-2 as tests/test_system.py); the sweep's "
        "kernel outputs against the plain version")
    for name, (args, out, decided) in outputs.items():
        want = vpe.registry.op(name).variants["reference"].fn(*args)
        if out.shape != want.shape or out.dtype != want.dtype:
            raise AssertionError(f"{name}: {decided} gives {tuple(out.shape)} "
                                 f"{out.dtype}, reference {tuple(want.shape)} {want.dtype}")
        if out.dtype in (torch.int32, torch.int64):
            if not torch.equal(out, want):
                raise AssertionError(f"{name}: {decided} differs from reference")
            say(f"  {name} [{decided}]: equal to reference ({out.dtype})")
        else:
            check_close(f"{name} [{decided}] vs reference", torch.view_as_real(out)
                        if out.is_complex() else out,
                        torch.view_as_real(want) if want.is_complex() else want,
                        2e-2, 2e-2)
    for n, (a, b) in sweep_inputs.items():
        check_close(f"sweep matmul {n}^3 cuda vs plain", kmm.matmul(a, b),
                    ref.matmul_ref(a, b), *matmul_tolerance(torch.float32, n))
    return dict(table1=rows, sweep=sweep, crossover=crossover, image_pipeline={
        k: v for k, v in pipeline.items() if k != "report"}, quickstart=quick,
        launches=launches, launches_by_part=split, wall_s=wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--trace", type=Path, default=None,
                    help="also profile the main path and write chrome "
                         "traces to this directory")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run this script "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # plain f32 versions are the yardstick: keep their products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from repro_torch.configs import get_config
    smi = phase_environment()
    phase_build()
    errors = phase_kernel_checks(dev)
    times = phase_kernel_times(dev, [len(p) for p in traffic(VOCAB)])
    errors["flash_attention"] = phase_flash_checks(dev)
    say("[3d] flash kernel time at the training path's shapes (median of 20 "
        "calls, L2 flushed before each)")
    times["flash_attention"] = phase_flash_time(dev, get_config(TRAIN_ARCH))
    cfg, params, prompts, main_run = phase_main_path(dev)
    fused = phase_fused_horizons(cfg, params, dev, prompts, main_run)
    auto = phase_auto_horizon(cfg, params, dev, prompts, main_run)
    phase_reduced_parity(dev)
    logits = phase_full_width_parity(cfg, params, dev, prompts[:SLOTS], atol=0.25)
    traces = phase_trace(cfg, params, dev, args.trace) if args.trace else None
    del params                      # the training phase needs the whole card
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(dev, args.trace)
    train_parity = phase_train_parity(dev)
    main_run["launches"]["flash_attention"] = train["launches"]
    paper_errors = phase_paper_kernel_checks(dev)
    paper_times = phase_paper_kernel_times(dev)
    paper = phase_paper_path(dev)
    main_run["launches"].update(paper["launches"])
    times.update(paper_times)
    # the paper path runs f32: its kernels' line holds their f32 errors
    # (bf16 errors are printed in phase 9 and kept in the report)
    errors.update({name: e["float32"] for name, e in paper_errors.items()})

    kernels = []
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "flash_attention", "matmul", "conv2d"):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": main_run["launches"][name],
            "max_abs_err": max(errors[name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    if args.report:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(
            dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                 kernel_times=times, check_errors=errors, main_path=main_run,
                 fused_horizons=fused, auto_horizon=auto,
                 full_width_logits=logits, traces=traces, train=train,
                 train_parity=train_parity, paper_check_errors=paper_errors,
                 paper=paper, kernels=kernels,
                 seconds=time.perf_counter() - t_start), indent=1, default=str))
    say(f"total {time.perf_counter() - t_start} s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
