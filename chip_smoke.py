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
   wgmma serialization ptxas reports, and one line for each conv2d
   instantiation (dtype, taps, tile) with its registers and spills;
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
4d. the prefix cache on the paged layout: 8 requests sharing a 392-token
   system prompt served cold (``prefix_blocks=0``), then on an engine whose
   tree a warm-up filled (``prefix_blocks=256``): each warm request aliases
   24 cached blocks and clones the 25th copy-on-write; hits, copies, tokens
   saved, TTFT and decode tok/s of both runs, the pool drained to the
   tree's pages, both paged kernels launched, first-token logits within
   0.25 of the cold run's, and the token agreement (a request whose tokens
   part gets the position and the logit margin there);
4e. the contiguous and ``auto`` layouts with ``attn_impl="flash_cuda"``:
   (i) phase 4's traffic on the contiguous layout, one flash launch a
   layer an admission, decode calls graph replays, first-token logits
   within 0.25 of phase 4's; (ii) phase 4d's traffic three times on one
   ``auto`` engine with the prefix cache, the paged kernels launched, the
   VPE's ``kv_layout`` and ``prefix_reuse`` decisions printed;
4f. page pressure: phase 4's engine and traffic (odd requests
   ``interactive``, even ones ``batch``) with ``page_budget=72`` against a
   worst case of 260, (i) resuming preempted requests by recompute and (ii)
   by swap; every request done, TTFT recorded once a request, the pool
   audit-clean and drained, at least one preemption in (i), as many
   swap-ins as swap-outs in (ii), no capture in a timed pass, and a swap
   round trip at this width bit-exact (gather, pinned host memory, scatter
   into other pages, gather again); TTFT by class, decode tok/s, the
   preemption, swap and rollback counters, each swap's wall and the first
   token parting from phase 4 printed; then (iii) phase 4's traffic with
   ``prefill_chunk="auto"`` under a VPE, three passes, the
   ``prefill_chunk`` decisions printed;
4g. speculation: phase 4's engine at ``decode_horizon = spec_draft = S``
   for S = 4 and 16, phase 4's traffic twice on one engine (pass 1 on a
   cold n-gram table, pass 2 replaying its streams); per pass the accept
   rate, tokens a verify call, the acceptance histogram, decode tok/s, the
   decode wall a step and the card's idle time in the decode-only steps;
   gates: verify calls replayed as CUDA graphs, no capture in pass 2,
   pass 2 accepting more than pass 1, tokens phase 4's or parting at a
   near-tie (the top-2 margin of a full forward there at most 0.25);
4h. faults and deadlines: phase 4's traffic with ``decode_horizon`` and
   ``spec_draft`` "auto", a ``StepWatchdog`` and a seeded storm of 8
   faults over the decode, fused, spec, prefill and page_alloc sites;
   gates: every request done or failed with a reason code, the pool
   drained, at least one demotion; then the traffic again without the
   plan: every rung re-promoted, tokens phase 4's or parting at a
   near-tie, the kernel's decode graphs replayed after ``decode_cuda``'s
   re-promotion; then a deadline of 0.05 s shed (``deadline``) and a
   queue bound of 6 shedding 2 of 8 (``capacity``);
5. serving parity: reduced qwen3-8b in f32, kernels against the gather
   path, greedy tokens equal, and fused horizons of 4 and 16 steps against
   single steps for both decode variants, plus an EOS that stops a horizon
   midway (tokens end at the first EOS); then, token for token, the prefix
   cache warm against cold, paged against contiguous against ``auto`` (its
   warm admissions forced paged), contiguous H = 4 against H = 1, and a
   copy-on-write tail shared by two resident requests, and a page budget
   near the floor (9 pages) with preemption by recompute and by swap at H =
   1 and 16 against the unpressured tokens, and speculation at S = 4 and 16
   on the paged and ``auto`` layouts against single steps (each prompt
   served twice, so drafts land); full width in bf16, first-step logits of
   the two;
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
   10^2 * 5x5, 512^2 * 5x5, 384^2 * 3x3, non-square taps, 40^2 * 32x32,
   widths whose rows do not start on 16 bytes, on both tiles, and 4096^2 *
   5x5), and, at phase 10's conv2d shapes in f32, the 3x3 and 5x5
   instantiations against the runtime-size one on both tiles, bit for bit;
10. their times at the paper path's shapes (matmul 512^3 and 4096^3,
   conv2d 512^2 * 5x5 and 384^2 * 3x3, f32, and conv2d 4096^2 * 5x5, a
   measurement row no path launches) beside the plain version's, one
   library call's and the bound; for conv2d also the kernel's own device
   time read from torch.profiler, its share of the bound and the launch
   floor (a one-element fill, timed as the kernels are);
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
steady 16-step horizon, 4 steady verify calls of span 4 (all graph
replays) and one prompt's prefill chunks, and one profiled training step in phase 7 (device busy share,
time by kernel, the profiler's own cost included), and writes the chrome
traces there, gzipped.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# the contiguous admission's whole-prompt prefill (phase 4e(i)): qwen3-8b's
# heads, causal, no window, S = T = the padded prompt lengths 64..512 (64 is
# a single q tile)
SERVE_FLASH_HEADS = (32, 8, 128)
SERVE_FLASH_CASES = tuple((S, S, True, None) for S in (64, 128, 256, 512))

# the paper path: matmul checks (m, k, n) — tests/test_kernels.py's shapes,
# the Table-1 512^3, one off every tile, the Fig. 2b sweep's largest — and
# conv2d checks (h, w, kh, kw) — the JAX tests' shapes, make_inputs at
# scale 0.02, the Table-1 512^2 * 5x5, the image pipeline's 384^2
# Laplacian, non-square taps, the largest taps, rows that do not start on
# 16 bytes (widths 61, 127 and 901; bf16 rows then also start at odd
# element offsets) on both tiles, and 4096^2 * 5x5 (the 64 x 64 tile)
MATMUL_CHECKS = ((128, 256, 128), (256, 512, 256), (100, 200, 60), (8, 8, 8),
                 (1, 512, 128), (384, 128, 384), (512, 512, 512), (1000, 1000, 1000),
                 (4096, 4096, 4096))
CONV_CHECKS = ((64, 64, 3, 3), (64, 64, 5, 5), (37, 53, 5, 5), (128, 96, 11, 11),
               (16, 16, 3, 3), (66, 64, 3, 3), (10, 10, 5, 5), (512, 512, 5, 5),
               (384, 384, 3, 3), (40, 48, 3, 5), (64, 61, 7, 1), (61, 64, 1, 7),
               (40, 40, 32, 32), (64, 61, 3, 3), (100, 127, 5, 5), (900, 901, 3, 3),
               (4096, 4096, 5, 5))
# conv2d times (image side, taps): Table 1, the image pipeline, and a
# measurement row at 4096^2 where the grid spans many waves
CONV_TIMES = ((512, 5), (384, 3), (4096, 5))
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
    JAX's 2e-4; bf16 one bf16 step (both sum at most 1,024 taps in f32 and
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
    entry, spilled, conv = None, [], {}
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "Performance Loss")):
            say(f"  {line.strip()}")
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "spill stores" in line and any(int(x) for x in re.findall(r"\d+", line)):
            spilled.append(entry)
        # conv2d_kernel<T, KH, KW, kTile>, mangled: ...conv2d_kernelIfLi5ELi5ELi0EE...
        m = re.search(r"conv2d_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E",
                      entry or "")
        if m and ("registers" in line or "spill stores" in line):
            dtype = "float32" if m[1] == "f" else "bfloat16"
            taps = f"{m[2]}x{m[3]}" if m[2] != "0" else "runtime size"
            conv.setdefault((dtype, taps, int(m[4])), []).append(line.strip())
    say(f"  kernels with a stack frame or spills: {spilled or 'none'}")
    for (dtype, taps, tile), lines in sorted(conv.items()):
        say(f"  conv2d_kernel {dtype}, taps {taps}, tile {tile}: {'; '.join(lines)}")
    if log and len(conv) != 12:
        raise AssertionError(f"ptxas reported {len(conv)} conv2d instantiations, "
                             f"not 12 (2 dtypes x 3 taps x 2 tiles)")
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


def serving_engine(cfg, params, dev, horizon, **kw):
    """The main path's engine: slots 4, max_len 1024, block 16, chunk 128,
    the paged layout and a VPE of its own unless ``kw`` says otherwise,
    both paged kernels pinned, decode horizon ``horizon`` (an int or
    ``"auto"``)."""
    from repro_torch.core import VPE
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine
    kw = {"kv_layout": "paged", "vpe": VPE(), "prefill_chunk": CHUNK, **kw}
    return ContinuousBatchingEngine(
        cfg, params, slots=SLOTS, max_len=MAX_LEN, block_size=BS,
        decode_horizon=horizon, decode_impl="cuda", prefill_kernel="cuda",
        device=dev, **kw)


class DecodeIdle:
    """The card's idle time in the engine steps that only decode (no
    admission, no prefill chunk): the host wall of each such step minus the
    device span of its replay (CUDA events around the decode or verify
    launch), unprofiled — phase 4's steady-window measure, over a whole
    run.  Installed on an engine for one run, then removed."""

    def __init__(self, engine):
        import torch
        self.engine, self.torch = engine, torch
        self.walls, self.spans = [], []
        graphs = engine.graphs
        self._step, self._launch, self._verify = (engine.step, graphs.launch,
                                                  graphs.verify)
        engine.step = self.step
        graphs.launch = lambda *a: self.timed(self._launch, *a)
        graphs.verify = lambda *a: self.timed(self._verify, *a)
        self._events = []

    def timed(self, fn, *args):
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        self._events.append((start, end, out[1]))
        return out

    def step(self):
        st = self.engine.stats
        before = (st.prefill_chunks, len(st.queue_wait_s), len(self._events))
        t0 = time.perf_counter()
        out = self._step()
        wall = time.perf_counter() - t0
        new = self._events[before[2]:]
        if (st.prefill_chunks, len(st.queue_wait_s)) == before[:2] and len(new) == 1 \
                and not new[0][2]:                       # one replay, no capture
            self.walls.append(wall)
            self.spans.append(new[0][:2])
        return out

    def remove(self):
        del self.engine.step
        del self.engine.graphs.launch
        del self.engine.graphs.verify
        self.torch.cuda.synchronize()
        span = [a.elapsed_time(b) / 1e3 for a, b in self.spans]
        n = len(self.walls)
        return dict(steps=n, wall_us_per_step=sum(self.walls) / n * 1e6 if n else None,
                    span_us_per_step=sum(span) / n * 1e6 if n else None,
                    idle_us_per_step=(sum(self.walls) - sum(span)) / n * 1e6 if n else None)


def serve_traffic(engine, cfg, prompts, label, rid0=0,
                  kernels=("paged_decode_attention", "paged_prefill_attention"),
                  priority=None, idle=False, faults=False):
    """Serve the traffic on ``engine`` with the launch counts zeroed just
    before and read just after; raise if a gate fails.  ``priority`` maps a
    request's index to its class (``batch`` without it).  Returns the run's
    record, with each request's first-token logits (the prompt's last
    position, on the card) under ``first_logits``.  Decode launches are the
    decode wrapper's own calls in the run plus the calls the graph replays
    stand for (``replayed_calls``); the profiled call of
    :func:`steady_window` shows that a replay launches the kernels.  Each
    kernel in ``kernels`` must have been launched; the pool must hold
    nothing but the prefix tree's pages after the drain; each request's
    TTFT is recorded once.  A speculative verify call is one decode step
    that launches no decode kernel.  ``idle`` also measures the idle time
    of the steps that only decode (:class:`DecodeIdle`).  With ``faults``
    a request may fail with a reason code, and the launch counts are not
    held to the steps and chunks (a demoted rung runs no kernel, a faulted
    chunk none)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.runtime.serve_loop import FAIL_REASONS, Request, ServeStats
    engine.completed.clear()
    engine.stats = ServeStats()
    graphs = engine.graphs
    engine.first_logits = {}
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    before = (graphs.captures, graphs.replays, graphs.replayed_calls,
              graphs.verify_captures, graphs.verify_replays)
    timer = DecodeIdle(engine) if idle else None
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=rid0 + i, prompt=p, max_new_tokens=NEW_TOKENS,
                              priority=priority(i) if priority else "batch"))
    try:
        done = engine.run()
        torch.cuda.synchronize()
    finally:
        idle_rec = timer.remove() if timer else None
    wall = time.perf_counter() - t0
    first_logits = {rid - rid0: x.float() for rid, x in engine.first_logits.items()}
    engine.first_logits = None
    captures = graphs.captures - before[0]
    replays = graphs.replays - before[1]
    replayed = graphs.replayed_calls - before[2]
    verify_captures = graphs.verify_captures - before[3]
    verify_replays = graphs.verify_replays - before[4]
    launches = {"paged_decode_attention": pa.paged_attention_cuda.launches + replayed,
                "paged_prefill_attention": pa.paged_prefill_attention_cuda.launches,
                "flash_attention": fa.flash_attention_cuda.launches}
    st = engine.stats
    say(f"  {st.summary()}")
    say(f"  wall {wall} s, {st.decode_steps} decode steps in "
        f"{sum(st.horizon_hist.values()) + st.spec_calls} decode calls (by horizon "
        f"{st.horizon_hist}, {st.spec_calls} verify calls), {st.prefill_chunks} "
        f"prefill chunks, TTFT mean "
        f"{st.mean_ttft_s} s max {max(st.ttft_s)} s, decode {st.decode_tok_per_s} "
        f"tok/s, decode wall a step {st.decode_s / st.decode_steps * 1e6} us, "
        f"reserved pages rolled back {st.reserved_pages_rolled_back}, launches "
        f"{launches} (decode: {pa.paged_attention_cuda.launches} wrapper calls, "
        f"{replayed} in {replays} graph replays)")
    say(f"  decode graphs: {graphs.captures} captures ({captures} in the run, "
        f"{st.tainted_steps} calls tainted), graph pool {graphs.pool_bytes()} B; "
        f"verify graphs: {graphs.verify_captures} captures ({verify_captures} in "
        f"the run), {verify_replays} replays in the run")
    served = [r for r in done if r.status == "done"]
    if len(done) != len(prompts) or (not faults and len(served) != len(done)) \
            or any(r.status not in ("done", "failed")
                   or (r.status == "failed" and r.error not in FAIL_REASONS)
                   for r in done):
        raise AssertionError(f"{label}: requests not completed: "
                             f"{[(r.rid, r.status, r.error) for r in done]}")
    if (not faults and len(st.ttft_s) != len(prompts)) \
            or not all(r.ttft_recorded for r in served):
        raise AssertionError(f"{label}: {len(st.ttft_s)} TTFTs recorded for "
                             f"{len(prompts)} requests")
    for r in served:
        if len(r.out) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"{label}: request {r.rid}: tokens {r.out}")
    if not {r.rid - rid0 for r in served} <= set(first_logits) or not all(
            bool(torch.isfinite(x).all()) for x in first_logits.values()):
        raise AssertionError(f"{label}: first-token logits missing or not finite")
    engine.check_kv()
    if engine.pages is not None:
        tree = engine.prefix_cache.owned_pages() if engine.prefix_cache else []
        if any(s.pages for s in engine.slots) or engine.pages.num_live != len(tree):
            raise AssertionError(f"{label}: {engine.pages.num_live} pages live after "
                                 f"the drain, {len(tree)} of them the tree's")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} was not launched on the main path")
    # decode-kernel calls a decode step stands for: one a layer when the
    # engine has pages and pins the kernel variant (a verify call: none)
    decode_calls = (cfg.num_layers if engine.pages is not None
                    and engine.decode_impl == "cuda" else 0)
    if replays != sum(st.horizon_hist.values()) or verify_replays != st.spec_calls \
            or (not faults
                and replayed != (st.decode_steps - st.spec_calls) * decode_calls):
        raise AssertionError(f"{label}: {replays} replays standing for {replayed} "
                             f"decode calls, for {st.horizon_hist} calls of "
                             f"{st.decode_steps} steps ({st.spec_calls} of them "
                             f"verify calls, {verify_replays} verify replays) x "
                             f"{decode_calls} layer calls")
    if not faults and \
            launches["paged_prefill_attention"] != st.prefill_chunks * cfg.num_layers:
        raise AssertionError(f"{label}: prefill launches {launches} do not match "
                             f"{st.prefill_chunks} chunks x {cfg.num_layers} layers")
    slot_calls = sum(st.accept_hist.values())
    return dict(
        wall_s=wall, decode_steps=st.decode_steps, prefill_chunks=st.prefill_chunks,
        ttft_s=list(st.ttft_s), mean_ttft_s=st.mean_ttft_s,
        decode_tok_per_s=st.decode_tok_per_s,
        decode_us_per_step=st.decode_s / st.decode_steps * 1e6,
        horizon_hist=dict(st.horizon_hist), rolled_back=st.reserved_pages_rolled_back,
        captures=graphs.captures, captures_in_run=captures,
        tainted_steps=st.tainted_steps, graph_pool_bytes=graphs.pool_bytes(),
        launches=launches, layers=cfg.num_layers,
        prefix=dict(lookups=st.prefix_lookups, hits=st.prefix_hits,
                    tokens_saved=st.prefix_tokens_saved, cow_copies=st.cow_copies,
                    paged_admits=st.paged_admits, sched_skips=st.sched_skips,
                    kv_place_s=list(st.kv_place_s)),
        pressure=dict(preemptions=st.preemptions,
                      decode_preemptions=st.decode_preemptions,
                      swap_outs=st.swap_outs, swap_ins=st.swap_ins,
                      swapped_pages=st.swapped_pages,
                      placement_rollbacks=st.placement_rollbacks,
                      swap_out_s=list(st.swap_out_s), swap_in_s=list(st.swap_in_s),
                      by_request={r.rid - rid0: r.preemptions for r in done}),
        ttft_by_request={r.rid - rid0: r.ttft_s for r in served},
        spec=dict(calls=st.spec_calls, draft_tokens=st.draft_tokens,
                  accepted_tokens=st.accepted_tokens,
                  accept_hist=dict(sorted(st.accept_hist.items())),
                  accept_rate=(st.accepted_tokens / st.draft_tokens
                               if st.draft_tokens else None),
                  tokens_per_verify=((st.accepted_tokens + slot_calls) / st.spec_calls
                                     if st.spec_calls else None)),
        verify_captures_in_run=verify_captures, verify_replays_in_run=verify_replays,
        faults=dict(device=st.device_faults, numeric=st.numeric_faults,
                    watchdog_trips=st.watchdog_trips, demotions=dict(st.demotions),
                    repromotions=st.repromotions,
                    failed_by_reason=dict(st.failed_by_reason),
                    status={r.rid - rid0: (r.status, r.error) for r in done}),
        idle=idle_rec,
        tokens={r.rid - rid0: r.out for r in served}, first_logits=first_logits)


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
    launch = graphs.launch

    def timed(impl, horizon):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(impl, horizon)
        end.record()
        spans.append((start, end))
        return out

    before = (st.decode_steps, st.prefill_chunks, graphs.captures)
    graphs.launch = timed
    try:
        t0 = time.perf_counter()
        for _ in range(calls):
            engine.step()
        wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        del graphs.launch                   # the bound method again
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
        run.pop("first_logits")
        out.append(run)
    decisions = {}
    say("  decode_horizon decisions (bucket: kept, tried, history):")
    for (op, bucket), d in sorted(engine.vpe.controller._decisions.items(), key=repr):
        if op == "decode_horizon":
            decisions[str(bucket)] = (d.selected, d.tried)
            say(f"    {bucket}: kept {d.selected}, tried {d.tried}, "
                f"{[f'{ev} {v}: {detail}' for ev, v, detail in d.history]}")
    return dict(passes=out, decisions=decisions)


SYSTEM_PROMPT, PREFIX_BLOCKS = 392, 256


def prefix_traffic(vocab: int, seed: int = 7):
    """Phase 4d's traffic: 8 prompts that share a 392-token system prompt
    (24 full blocks and 8 tokens of a 25th), each followed by a suffix of
    its own of 32–160 tokens; and the warm-up prompt, the system prompt and
    40 tokens more (27 full blocks), whose blocks a warm engine caches."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, SYSTEM_PROMPT).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, vocab, int(n)).astype(np.int32)])
               for n in rng.integers(32, 161, REQUESTS)]
    warm = np.concatenate([system, rng.integers(0, vocab, 40).astype(np.int32)])
    return prompts, warm


def warm_up(engine, prompt):
    """One 2-token request: it captures the single-step decode graph (and,
    with a prefix cache, leaves the prompt's full blocks in the tree)."""
    from repro_torch.runtime.serve_loop import Request
    engine.submit(Request(rid=-1, prompt=prompt, max_new_tokens=2))
    engine.run()


def token_margin(cfg, params, prompt, before, a, b):
    """Where two runs part: a full forward over the prompt and the tokens
    before that position; logit[a] - logit[b] at its last position, and the
    top-2 margin there."""
    import torch
    from repro_torch.models import model as model_lib
    seq = np.concatenate([prompt, np.asarray(before, np.int32)])[None]
    with torch.no_grad():
        logits = model_lib.forward(cfg, params, {"tokens": torch.from_numpy(seq).to(
            params["embed"].device)})[0, -1]
    top2 = torch.topk(logits, 2).values
    return dict(a_minus_b=float(logits[a] - logits[b]),
                top2_margin=float(top2[0] - top2[1]))


def compare_runs(label, ref_label, ref, run, cfg, params, prompts, atol=None,
                 tie=None):
    """Each request's first-token logits in ``run`` against ``ref``'s (gated
    within ``atol`` when given), and its tokens: printed, and for each
    request whose tokens part, the first position and the logit margin
    there — gated, when ``tie`` is given, to a top-2 margin of at most
    ``tie`` (a near-tie).  Requests missing from ``run`` (failed) are
    left out."""
    errs = [float((run["first_logits"][r] - ref["first_logits"][r]).abs().max())
            for r in sorted(ref["first_logits"]) if r in run["first_logits"]]
    say(f"  {label} vs {ref_label}: first-token logits max abs diff by request "
        f"{errs}" + (f" (tolerance {atol})" if atol is not None else ""))
    parts = []
    for rid, toks in sorted(ref["tokens"].items()):
        if rid not in run["tokens"]:
            continue
        got = run["tokens"][rid]
        if got != toks:
            j = next(k for k in range(len(toks)) if got[k] != toks[k])
            margin = token_margin(cfg, params, prompts[rid], toks[:j], toks[j], got[j])
            parts.append(dict(rid=rid, position=j, ref_token=toks[j],
                              token=got[j], **margin))
    compared = sum(1 for rid in ref["tokens"] if rid in run["tokens"])
    same = compared - len(parts)
    say(f"  tokens equal to {ref_label}'s in {same} of {compared} "
        f"requests" + "".join(
            f"; request {p['rid']} parts at position {p['position']} ({p['ref_token']}"
            f" / {p['token']}), logit margin there {p['a_minus_b']} (top-2 "
            f"{p['top2_margin']}, full forward)" for p in parts))
    if atol is not None and max(errs) > atol:
        raise AssertionError(f"{label}: first-token logits differ from {ref_label}'s "
                             f"by {max(errs)} > {atol}")
    wide = [p for p in parts if tie is not None and p["top2_margin"] > tie]
    if wide:
        raise AssertionError(f"{label}: tokens part from {ref_label}'s where the "
                             f"top-2 margin is above {tie}: {wide}")
    return dict(first_logit_max_abs_diff=errs, tokens_equal=same, compared=compared,
                parted=parts)


def phase_prefix_cache(cfg, params, dev):
    """Phase 4d: the prefix cache on the paged layout, both paged kernels
    pinned.  Phase 4d's traffic is served cold (``prefix_blocks=0``), then
    on an engine whose tree the warm-up filled (``prefix_blocks=256``):
    every request aliases 24 cached blocks and clones the 25th, whose 8
    system-prompt tokens it matches, so its first chunk starts mid-block
    in the clone.  The engines run without a VPE, so no admission trials
    recomputing its match.  Gates: >= 7 hits, >= 1 copy-on-write, the drained pool
    holding only tree pages, both paged kernels launched in the warm run,
    first-token logits within 0.25 of the cold run's."""
    import torch
    t0 = time.perf_counter()
    prompts, warm = prefix_traffic(cfg.vocab_size)
    say(f"[4d] prefix cache, paged: {cfg.name} at full width, {REQUESTS} requests "
        f"sharing a {SYSTEM_PROMPT}-token system prompt, prompt lengths "
        f"{[len(p) for p in prompts]}, {NEW_TOKENS} new tokens each; cold "
        f"(prefix_blocks 0), then warm (prefix_blocks {PREFIX_BLOCKS})")
    runs = {}
    for label, blocks in (("cold", 0), ("warm", PREFIX_BLOCKS)):
        # no VPE: every warm admission reuses its match (the prefix_reuse
        # axis would trial recomputing it), so the run measures the cache
        engine = serving_engine(cfg, params, dev, 1, prefix_blocks=blocks, vpe=None)
        warm_up(engine, warm)
        tree = engine.prefix_cache.live_blocks if engine.prefix_cache else 0
        say(f"  {label}: {engine.pages.num_pages} pages + trash, {tree} blocks in "
            f"the tree after the warm-up")
        run = serve_traffic(engine, cfg, prompts, f"phase 4d {label}")
        if run["captures_in_run"]:
            raise AssertionError(f"phase 4d {label}: a capture in the timed run")
        run["tree_blocks"] = engine.prefix_cache.live_blocks if blocks else 0
        runs[label] = run
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    warm_run, cold_run = runs["warm"], runs["cold"]
    pre = warm_run["prefix"]
    say(f"  warm: {pre['hits']}/{pre['lookups']} prefix hits, {pre['tokens_saved']} "
        f"prompt tokens served from cached pages, {pre['cow_copies']} copy-on-write "
        f"clones, kv_place_s mean {np.mean(pre['kv_place_s'])} s, "
        f"{warm_run['prefill_chunks']} prefill chunks (cold: "
        f"{cold_run['prefill_chunks']}), {warm_run['tree_blocks']} tree blocks "
        f"after the drain")
    for label, run in runs.items():
        say(f"  {label}: TTFT mean {run['mean_ttft_s']} s, decode "
            f"{run['decode_tok_per_s']} tok/s")
    if pre["hits"] < REQUESTS - 1 or pre["cow_copies"] < 1 \
            or pre["tokens_saved"] < pre["hits"] * SYSTEM_PROMPT:
        raise AssertionError(f"phase 4d: {pre['hits']} hits, {pre['cow_copies']} "
                             f"copy-on-write clones")
    cmp = compare_runs("phase 4d warm", "the cold run", cold_run, warm_run, cfg,
                       params, prompts, atol=0.25)
    cold = dict(tokens=cold_run["tokens"], first_logits=cold_run["first_logits"])
    for run in runs.values():
        run.pop("first_logits")
    wall = time.perf_counter() - t0
    say(f"  phase 4d wall {wall} s")
    return dict(runs=runs, compare=cmp, wall_s=wall), cold


def phase_layouts(cfg, params, dev, prompts, main, main_logits, cold_4d):
    """Phase 4e: the contiguous and ``auto`` layouts, with the prefill of
    contiguous admissions through the flash kernel (``attn_impl =
    flash_cuda``).  (i) Phase 4's traffic on the contiguous layout, whose
    padded prompt lengths phase 3c checked the flash kernel at: one flash
    launch a layer an admission, every decode call a graph replay
    (none captured in the run), first-token logits within 0.25 of phase
    4's.  (ii) Phase 4d's traffic three times on one ``auto`` engine with
    the prefix cache: the paged kernels launched, the pool audit clean;
    the VPE's ``kv_layout`` and ``prefix_reuse`` decisions printed."""
    import torch
    from repro_torch.core import VPE, pad_to_bucket
    t0 = time.perf_counter()
    cfg_f = dataclasses.replace(cfg, attn_impl="flash_cuda")
    say(f"[4e] contiguous and auto layouts: {cfg.name} at full width, "
        f"attn_impl=flash_cuda; (i) phase 4's traffic, contiguous")
    engine = serving_engine(cfg_f, params, dev, 1, kv_layout="contiguous")
    warm = np.arange(1, 200, dtype=np.int32)
    pads = {min(pad_to_bucket(len(p), minimum=engine.min_prompt_pad), engine.max_len)
            for p in [*prompts, warm]}
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    if heads != SERVE_FLASH_HEADS or not pads <= {c[0] for c in SERVE_FLASH_CASES}:
        raise AssertionError(f"phase 4e(i): flash prefill at {heads} heads, padded "
                             f"lengths {sorted(pads)}, not among phase 3c's checks")
    warm_up(engine, warm)
    slot_bytes = sum(engine.cache[k].numel() * engine.cache[k].element_size()
                     for k in "kv")
    say(f"  engine: slot cache {slot_bytes} B, {engine.graphs.captures} decode "
        f"graphs captured in the warm-up")
    run = serve_traffic(engine, cfg_f, prompts, "phase 4e(i)",
                        kernels=("flash_attention",))
    flash = run["launches"]["flash_attention"]
    if run["captures_in_run"] or flash != cfg.num_layers * REQUESTS:
        raise AssertionError(f"phase 4e(i): {run['captures_in_run']} captures in "
                             f"the run, {flash} flash launches for {REQUESTS} "
                             f"admissions x {cfg.num_layers} layers")
    contiguous = dict(run=run, compare=compare_runs(
        "phase 4e(i)", "phase 4", dict(main, first_logits=main_logits), run, cfg,
        params, prompts, atol=0.25))
    run.pop("first_logits")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    prompts_d, warm = prefix_traffic(cfg.vocab_size)
    say("  (ii) phase 4d's traffic three times, kv_layout=auto, prefix_blocks "
        f"{PREFIX_BLOCKS}")
    engine = serving_engine(cfg_f, params, dev, 1, kv_layout="auto",
                            prefix_blocks=PREFIX_BLOCKS,
                            vpe=VPE(controller_kwargs=dict(min_samples=2,
                                                           trial_samples=2)))
    warm_up(engine, warm)
    passes, launches = [], {}
    for k in range(3):
        run = serve_traffic(engine, cfg_f, prompts_d, f"phase 4e(ii) pass {k}",
                            rid0=100 * (k + 1), kernels=("paged_decode_attention",))
        if run["captures_in_run"]:
            raise AssertionError(f"phase 4e(ii) pass {k}: {run['captures_in_run']} "
                                 f"captures in the timed run")
        run["compare"] = compare_runs(f"phase 4e(ii) pass {k}", "phase 4d cold",
                                      cold_4d, run, cfg, params, prompts_d)
        run.pop("first_logits")
        say(f"  pass {k}: {run['prefix']['paged_admits']} paged admissions of "
            f"{REQUESTS}, TTFT mean {run['mean_ttft_s']} s, decode "
            f"{run['decode_tok_per_s']} tok/s")
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
        passes.append(run)
    say(f"  launches over the three passes: {launches}")
    if launches["paged_prefill_attention"] <= 0 or launches["paged_decode_attention"] <= 0:
        raise AssertionError(f"phase 4e(ii): paged kernels not launched: {launches}")
    decisions = {}
    say("  kv_layout and prefix_reuse decisions (bucket: kept, tried, history):")
    for (op, bucket), d in sorted(engine.vpe.controller._decisions.items(), key=repr):
        if op in ("kv_layout", "prefix_reuse"):
            decisions[f"{op} {bucket}"] = (d.selected, d.tried)
            say(f"    {op} {bucket}: kept {d.selected}, tried {d.tried}, "
                f"{[f'{ev} {v}: {detail}' for ev, v, detail in d.history]}")
    wall = time.perf_counter() - t0
    say(f"  phase 4e wall {wall} s")
    return dict(contiguous=contiguous, auto=dict(passes=passes, launches=launches,
                                                  decisions=decisions), wall_s=wall)


PAGE_BUDGET = 72


def interactive_odd(i):
    """Phase 4f's classes: odd requests interactive, even ones batch."""
    return "interactive" if i % 2 else "batch"


def swap_roundtrip(engine, dev):
    """A swap round trip on ``engine``'s drained full-width pool: pages 0-2
    (K/V of the traffic just served) copied by ``swap_out_pages`` into
    pinned host memory, scattered by ``swap_in_pages`` into pages 3-5 (the
    trash page padding the ids to 4, with a negative start), gathered
    again; whether the filled 43 positions came back bit for bit, and the
    fenced walls of the two halves."""
    import torch
    from repro_torch.models import kvcache
    pool, filled = engine.page_pool, 3 * BS - 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k, v = kvcache.swap_out_pages(pool, torch.tensor([0, 1, 2, 0], device=dev))
    t1 = time.perf_counter()
    kvcache.swap_in_pages(pool, k, v, torch.tensor([3, 4, 5, engine.pages.trash_id]),
                          torch.tensor([0, BS, 2 * BS, -BS]), filled)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    want = kvcache.gather_pages(pool, torch.tensor([0, 1, 2], device=dev))
    back = kvcache.gather_pages(pool, torch.tensor([3, 4, 5], device=dev))
    exact = k.is_pinned() and all(
        torch.equal(b[..., :filled, :], w[..., :filled, :])
        and torch.equal(h[..., :filled, :], w[..., :filled, :].cpu())
        for b, w, h in zip(back, want, (k, v)))
    return dict(exact=exact, bytes=2 * k.numel() * k.element_size(),
                swap_out_s=t1 - t0, swap_in_s=t2 - t1)


def phase_pressure(cfg, params, dev, prompts, main, main_logits):
    """Phase 4f: page pressure on phase 4's engine and traffic, odd
    requests interactive and even ones batch, ``page_budget=72`` (the floor
    is 66, the worst case 260): (i) preempted requests resume by recompute,
    (ii) by swap.  Gates: every request done with its TTFT recorded once,
    the pool audit-clean and drained, no capture in a timed pass, at least
    one preemption in (i), swap-ins equal to swap-outs (at least one) in
    (ii), a swap round trip bit-exact.  Tokens against phase 4's are printed
    with the margin where they part (bf16 logits tie).  Then (iii): phase
    4's traffic three times with ``prefill_chunk="auto"`` under a VPE; the
    ``prefill_chunk`` decisions printed."""
    import torch
    from repro_torch.core import VPE
    t0 = time.perf_counter()
    page_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * BS * cfg.head_dim * 2
    say(f"[4f] page pressure: {cfg.name} at full width, phase 4's traffic, odd "
        f"requests interactive, even batch; page_budget {PAGE_BUDGET} (floor "
        f"{NB + 2}, worst case {SLOTS * NB + SLOTS}), {page_bytes} B a page, pool "
        f"{PAGE_BUDGET * page_bytes} B")
    ref = dict(main, first_logits=main_logits)
    runs = {}
    for label, swap in (("recompute", False), ("swap", True)):
        engine = serving_engine(cfg, params, dev, 1, page_budget=PAGE_BUDGET, swap=swap)
        warm_up(engine, np.arange(1, 200, dtype=np.int32))
        run = serve_traffic(engine, cfg, prompts, f"phase 4f {label}",
                            priority=interactive_odd)
        pr = run["pressure"]
        ttft = {c: [run["ttft_by_request"][r] for r in sorted(run["ttft_by_request"])
                    if interactive_odd(r) == c] for c in ("interactive", "batch")}
        run["ttft_by_class"] = {c: dict(mean=float(np.mean(x)), max=max(x))
                                for c, x in ttft.items()}
        say(f"  ({label}) preemptions {pr['preemptions']} ({pr['decode_preemptions']} "
            f"decoding; by request {pr['by_request']}), swaps out/in "
            f"{pr['swap_outs']}/{pr['swap_ins']} ({pr['swapped_pages']} pages), "
            f"placement rollbacks {pr['placement_rollbacks']}; swap-out wall "
            f"{pr['swap_out_s']} s, swap-in wall {pr['swap_in_s']} s")
        say(f"  ({label}) TTFT interactive mean {run['ttft_by_class']['interactive']} "
            f"s, batch {run['ttft_by_class']['batch']} s; decode "
            f"{run['decode_tok_per_s']} tok/s")
        if run["captures_in_run"]:
            raise AssertionError(f"phase 4f {label}: a capture in the timed run")
        if not swap and pr["preemptions"] < 1:
            raise AssertionError("phase 4f recompute: no preemption under the budget")
        if swap and (pr["swap_outs"] < 1 or pr["swap_outs"] != pr["swap_ins"]):
            raise AssertionError(f"phase 4f swap: {pr['swap_outs']} swap-outs, "
                                 f"{pr['swap_ins']} swap-ins")
        run["compare"] = compare_runs(f"phase 4f {label}", "phase 4", ref, run, cfg,
                                      params, prompts)
        if swap:
            rt = swap_roundtrip(engine, dev)
            say(f"  swap round trip of 3 pages ({rt['bytes']} B) at this width: "
                f"bit-exact {rt['exact']}, out {rt['swap_out_s']} s, in "
                f"{rt['swap_in_s']} s")
            if not rt["exact"]:
                raise AssertionError("phase 4f: the swap round trip is not bit-exact")
            run["roundtrip"] = rt
        run.pop("first_logits")
        runs[label] = run
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    say("  (iii) phase 4's traffic three times, prefill_chunk=auto over whole, 128, "
        "512, 2048")
    engine = serving_engine(cfg, params, dev, 1, prefill_chunk="auto",
                            vpe=VPE(controller_kwargs=dict(min_samples=1,
                                                           trial_samples=2)))
    warm_up(engine, np.arange(1, 200, dtype=np.int32))
    passes = []
    for k in range(3):
        run = serve_traffic(engine, cfg, prompts, f"phase 4f(iii) pass {k}",
                            rid0=100 * (k + 1))
        if run["captures_in_run"]:
            raise AssertionError(f"phase 4f(iii) pass {k}: a capture in the timed run")
        run["compare"] = compare_runs(f"phase 4f(iii) pass {k}", "phase 4", ref, run,
                                      cfg, params, prompts)
        run.pop("first_logits")
        say(f"  pass {k}: {run['prefill_chunks']} prefill chunks, TTFT mean "
            f"{run['mean_ttft_s']} s, decode {run['decode_tok_per_s']} tok/s")
        passes.append(run)
    decisions = {}
    say("  prefill_chunk decisions (bucket: kept, tried, history):")
    for (op, bucket), d in sorted(engine.vpe.controller._decisions.items(), key=repr):
        if op == "prefill_chunk":
            decisions[str(bucket)] = (d.selected, d.tried)
            say(f"    {bucket}: kept {d.selected}, tried {d.tried}, "
                f"{[f'{ev} {v}: {detail}' for ev, v, detail in d.history]}")
    if not decisions:
        raise AssertionError("phase 4f(iii): the prefill_chunk axis made no decision")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    say(f"  phase 4f wall {wall} s")
    return dict(runs=runs, chunk_axis=dict(passes=passes, decisions=decisions),
                page_budget=PAGE_BUDGET, page_bytes=page_bytes, wall_s=wall)


# tokens may part from phase 4's only where the top-2 margin of a full
# forward is at most this (PERF.md section 2's limit across prefill paths)
TIE_MARGIN = 0.25
# phase 4h's storm: FaultPlan.seeded over the engine's five sites
FAULT_SEED, FAULT_STORM, FAULT_SPAN = 5, 8, 40
FAULT_SITES = ("decode", "fused", "spec", "prefill", "page_alloc")


def say_spec(label, run):
    sp, idle = run["spec"], run["idle"]
    say(f"  {label}: accept rate {sp['accept_rate']} ({sp['accepted_tokens']}/"
        f"{sp['draft_tokens']} drafts), tokens a verify call "
        f"{sp['tokens_per_verify']} ({sp['calls']} verify calls), accept_hist "
        f"{sp['accept_hist']}; decode {run['decode_tok_per_s']} tok/s, decode wall a "
        f"step {run['decode_us_per_step']} us, idle {idle['idle_us_per_step']} us a "
        f"step over {idle['steps']} decode-only steps (host {idle['wall_us_per_step']}"
        f" us, replay span {idle['span_us_per_step']} us); verify captures "
        f"{run['verify_captures_in_run']}, replays {run['verify_replays_in_run']}")


def phase_speculation(cfg, params, dev, prompts, main, main_logits):
    """Phase 4g: speculative decoding on phase 4's engine (paged, both
    kernels pinned) at ``decode_horizon = spec_draft = S`` for S = 4 and
    16, phase 4's traffic twice on one engine: pass 1 on a cold n-gram
    table, pass 2 the same prompts again, whose drafts replay pass 1's
    greedy streams (the operators' repeated traffic).  Gates: no capture
    in pass 2, verify replays in both passes, pass 2's accept rate above
    pass 1's, and each request's tokens phase 4's or parting only at a
    near-tie (top-2 margin <= TIE_MARGIN)."""
    import torch
    t0 = time.perf_counter()
    ref = dict(main, first_logits=main_logits)
    say(f"[4g] speculation: {cfg.name} at full width, phase 4's engine, "
        f"decode_horizon = spec_draft = S, phase 4's traffic twice on one engine")
    out = {}
    for S in (4, 16):
        engine = serving_engine(cfg, params, dev, S, spec_draft=S)
        passes = []
        for k in range(2):
            label = f"phase 4g S={S} pass {k + 1}"
            # the verify read is the gather path: a pass whose every step
            # speculates launches no decode kernel, so only the prefill
            # kernel is required (decode launches are printed)
            run = serve_traffic(engine, cfg, prompts, label, rid0=100 * (k + 1),
                                kernels=("paged_prefill_attention",), idle=True)
            say_spec(label, run)
            run["compare"] = compare_runs(label, "phase 4", ref, run, cfg, params,
                                          prompts, tie=TIE_MARGIN)
            run.pop("first_logits")
            passes.append(run)
        cold, warm = passes
        if warm["captures_in_run"] or warm["verify_captures_in_run"]:
            raise AssertionError(f"phase 4g S={S}: a capture in pass 2")
        if not (cold["verify_replays_in_run"] and warm["verify_replays_in_run"]):
            raise AssertionError(f"phase 4g S={S}: no verify replay in a pass")
        if not warm["spec"]["accept_rate"] > (cold["spec"]["accept_rate"] or 0.0):
            raise AssertionError(f"phase 4g S={S}: pass 2's accept rate "
                                 f"{warm['spec']['accept_rate']} is not above pass "
                                 f"1's {cold['spec']['accept_rate']}")
        out[S] = passes
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    say(f"  phase 4g wall {wall} s")
    return dict(spans=out, wall_s=wall)


def phase_faults(cfg, params, dev, prompts, main, main_logits):
    """Phase 4h: faults and deadlines.  Phase 4's traffic on the paged
    layout, both kernels pinned, ``decode_horizon`` and ``spec_draft``
    "auto" under a VPE, a real ``StepWatchdog`` and a storm of
    ``FaultPlan.seeded(seed=5, n=8, span=40, slots=4)`` over the five
    sites.  Gates: every request done or failed with a reason code, the
    pool audit-clean and drained, at least one demotion.  Then phase 4's
    traffic again on the same engine without the plan: every rung
    re-promoted by its end, its tokens phase 4's or parting at a near-tie,
    and, if ``decode_cuda`` was demoted, the kernel's graphs replayed after
    its re-promotion.  Then, on a new engine and no plan: one request with
    ``deadline_s=0.05`` shed with reason ``deadline``, and
    ``max_queue_depth=6`` shedding 2 of 8 submitted at once (``capacity``)."""
    import torch
    from repro_torch.distributed.straggler import StepWatchdog
    from repro_torch.runtime.serve_faults import FaultPlan
    from repro_torch.runtime.serve_loop import Request, ServeStats
    t0 = time.perf_counter()
    ref = dict(main, first_logits=main_logits)
    plan = FaultPlan.seeded(FAULT_SEED, FAULT_STORM, span=FAULT_SPAN, slots=SLOTS,
                            sites=FAULT_SITES)
    say(f"[4h] faults and deadlines: {cfg.name} at full width, phase 4's traffic, "
        f"decode_horizon and spec_draft auto, a StepWatchdog, the storm "
        f"{[(f.site, f.kind, f.at, f.slot) for f in plan.specs]}")
    engine = serving_engine(cfg, params, dev, "auto", spec_draft="auto",
                            fault_plan=plan, watchdog=StepWatchdog())
    # when decode_cuda is re-promoted, how many calls the kernel's graphs
    # had replayed: the clean pass must add to them
    promoted_at = []
    tick = engine._tick_probation

    def watched_tick():
        was = engine._rung_demoted("decode_cuda")
        tick()
        if was and not engine._rung_demoted("decode_cuda"):
            promoted_at.append(engine.graphs.replayed_calls_of("cuda"))
    engine._tick_probation = watched_tick
    storm = serve_traffic(engine, cfg, prompts, "phase 4h storm", rid0=100,
                          faults=True)
    fa = storm["faults"]
    say(f"  storm: {len(plan.injected)}/{len(plan)} planned faults fired "
        f"{[(f.site, f.kind, f.at, f.slot) for f in plan.injected]}; device "
        f"{fa['device']}, numeric {fa['numeric']}, watchdog trips "
        f"{fa['watchdog_trips']}, demotions {fa['demotions']}, re-promotions "
        f"{fa['repromotions']}, failed {fa['failed_by_reason']}, by request "
        f"{fa['status']}")
    storm["compare"] = compare_runs("phase 4h storm survivors", "phase 4", ref,
                                    storm, cfg, params, prompts)
    if not fa["demotions"]:
        raise AssertionError("phase 4h: the storm demoted no rung")
    unfired = [(f.site, f.kind, f.at) for f in plan.specs if f not in plan.injected]
    engine.faults = None
    say(f"  clean pass: the plan detached ({len(unfired)} planned faults never "
        f"reached: {unfired}), rungs still demoted {dict(engine._demoted)}")
    cuda_before = engine.graphs.replayed_calls_of("cuda")
    clean = serve_traffic(engine, cfg, prompts, "phase 4h clean pass", rid0=200,
                          faults=True)
    clean["compare"] = compare_runs("phase 4h clean pass", "phase 4", ref, clean, cfg,
                                    params, prompts, tie=TIE_MARGIN)
    cuda_after = engine.graphs.replayed_calls_of("cuda")
    say(f"  clean pass: demotions {clean['faults']['demotions']}, re-promotions "
        f"{clean['faults']['repromotions']}, rungs still demoted "
        f"{dict(engine._demoted)}; decode_cuda re-promoted with the kernel's graphs "
        f"at {promoted_at} replayed calls, {cuda_before} before the pass, "
        f"{cuda_after} after it")
    if clean["faults"]["failed_by_reason"] or len(clean["tokens"]) != len(prompts):
        raise AssertionError(f"phase 4h clean pass: {clean['faults']['status']}")
    if engine._demoted:
        raise AssertionError(f"phase 4h: rungs {engine._demoted} not re-promoted by "
                             f"the end of the clean pass")
    demoted_decode = "decode_cuda" in {**fa["demotions"],
                                       **clean["faults"]["demotions"]}
    if demoted_decode and not (promoted_at and cuda_after > promoted_at[-1]):
        raise AssertionError(f"phase 4h: the cuda decode graphs did not replay after "
                             f"decode_cuda's re-promotion ({promoted_at}, "
                             f"{cuda_after})")
    for run in (storm, clean):
        run.pop("first_logits")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # deadlines and the queue bound, no plan
    engine = serving_engine(cfg, params, dev, 1, max_queue_depth=6)
    engine.stats = ServeStats()
    reqs = [Request(rid=300 + i, prompt=p, max_new_tokens=NEW_TOKENS,
                    deadline_s=0.05 if i == 0 else None)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    st = engine.stats
    shed = {r.rid - 300: (r.status, r.error, r.error_detail) for r in reqs
            if r.status == "failed"}
    say(f"  deadline 0.05 s on request 0, max_queue_depth 6, 8 submitted at once: "
        f"failed {st.failed_by_reason}, {shed}; done "
        f"{sum(r.status == 'done' for r in reqs)}")
    if st.failed_by_reason != {"capacity": 2, "deadline": 1} \
            or reqs[0].error != "deadline" \
            or {r.error for r in reqs[-2:]} != {"capacity"} \
            or sum(r.status == "done" for r in reqs) != 5:
        raise AssertionError(f"phase 4h shedding: {st.failed_by_reason}, {shed}")
    engine.check_kv()
    if not engine.pages.drained:
        raise AssertionError("phase 4h shedding: the pool did not drain")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    say(f"  phase 4h wall {wall} s")
    return dict(plan=[(f.site, f.kind, f.at, f.slot) for f in plan.specs],
                fired=[(f.site, f.kind, f.at, f.slot) for f in plan.injected],
                storm=storm, clean=clean, promoted_at=promoted_at,
                shedding=dict(failed_by_reason=dict(st.failed_by_reason),
                              shed={k: v[:2] for k, v in shed.items()}),
                wall_s=wall)


def run_engine(cfg, params, dev, impls, prompts, new_tokens, eos=None, warm=None,
               force_paged=False, priority=None, stats=None, **kw):
    """Serve ``prompts`` (rids 0...) on a new engine, the paged layout unless
    ``kw`` says otherwise, after a 2-token request for each prompt in
    ``warm`` (rids < 0: they fill the prefix tree); ``force_paged`` pins
    an ``auto`` engine's warm admissions to the paged layout (``"all"``:
    its cold ones too); ``priority``
    maps a request's index to its class; the engine's stats are appended
    to ``stats`` when it is a list.  Returns each request's tokens; raises
    unless every request is done and the pool holds only tree pages after
    the drain."""
    from repro_torch.core import VPE, kv_layout_bucket, kv_layout_buckets
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request
    kw = {"kv_layout": "paged", **kw}
    eng = ContinuousBatchingEngine(cfg, params, decode_impl=impls[0],
                                   prefill_kernel=impls[1], device=dev,
                                   vpe=VPE() if force_paged else None, **kw)
    if force_paged:
        buckets = kv_layout_buckets(kw["max_len"], eng.num_slots,
                                    levels=eng.occupancy_levels)
        if force_paged == "all":
            buckets += [kv_layout_bucket(0, occ, eng.num_slots,
                                         levels=eng.occupancy_levels)
                        for occ in range(eng.num_slots + 1)]
        for bucket in buckets:
            eng.vpe.controller.force("kv_layout", bucket, "paged")
    for j, p in enumerate(warm or ()):
        eng.submit(Request(rid=-1 - j, prompt=p, max_new_tokens=2))
        eng.run()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens, eos_id=eos,
                           priority=priority(i) if priority else "batch"))
    done = eng.run()
    if any(r.status != "done" for r in done):
        raise AssertionError(f"requests not done: {[(r.rid, r.status) for r in done]}")
    eng.check_kv()
    tree = eng.prefix_cache.owned_pages() if eng.prefix_cache else []
    if eng.pages is not None and eng.pages.num_live != len(tree):
        raise AssertionError("page pool not drained to the tree's pages")
    if force_paged and not eng.stats.paged_admits:
        raise AssertionError("no admission went paged under the forced flip")
    if stats is not None:
        stats.append(eng.stats)
    return {r.rid: r.out for r in done if r.rid >= 0}


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
    # page pressure: 9 pages (the floor is 8), odd requests interactive;
    # preempted requests resume by recompute or from host memory, at H = 1
    # and 16, and give the unpressured tokens
    for horizon in (1, 16):
        for swap in (False, True):
            st = []
            got = run_engine(cfg, params, dev, ("cuda", "cuda"), prompts, 12,
                             page_budget=9, swap=swap, decode_horizon=horizon,
                             priority=interactive_odd, stats=st, **kw)
            st = st[0]
            say(f"  page_budget 9, H={horizon}, {'swap' if swap else 'recompute'}: "
                f"{st.preemptions} preemptions ({st.decode_preemptions} decoding), "
                f"swaps {st.swap_outs}/{st.swap_ins}, tokens == unpressured: "
                f"{got == kernels}")
            if got != kernels or st.preemptions < 1 or st.swap_outs != st.swap_ins \
                    or (swap and st.swap_outs < 1):
                raise AssertionError(f"page pressure H={horizon} swap={swap}: {got} "
                                     f"!= {kernels}, or {st.preemptions} preemptions, "
                                     f"swaps {st.swap_outs}/{st.swap_ins}")
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
    # speculation against single steps, token for token: every prompt twice,
    # so the second serving's drafts replay the first's stream and land;
    # on auto the admissions go contiguous (no VPE) or are forced paged
    twice = prompts + prompts
    want_twice = {i: kernels[i % len(prompts)] for i in range(len(twice))}
    for label, extra in (("paged", dict(kv_layout="paged")),
                         ("auto", dict(kv_layout="auto")),
                         ("auto, forced paged", dict(kv_layout="auto",
                                                     force_paged="all"))):
        for span in (4, 16):
            st = []
            got = run_engine(cfg, params, dev, ("cuda", "cuda"), twice, 12,
                             decode_horizon=span, spec_draft=span, stats=st,
                             **{**kw, **extra})
            st = st[0]
            say(f"  {label}, spec_draft={span}: {st.spec_calls} verify calls, "
                f"{st.accepted_tokens}/{st.draft_tokens} drafts accepted, tokens "
                f"== H=1: {got == want_twice}")
            if got != want_twice or not st.spec_calls or not st.accepted_tokens:
                raise AssertionError(f"{label} spec_draft={span}: {got} != "
                                     f"{want_twice}, or {st.spec_calls} verify "
                                     f"calls, {st.accepted_tokens} accepted")
    # the layouts and the prefix cache: prompts sharing 37 tokens (2 full
    # blocks and 5 of a third, so paged warm admissions clone it), the
    # contiguous prefill through the flash kernel (its f32 body)
    cfg_f = dataclasses.replace(cfg, attn_impl="flash_cuda")
    system = rng.integers(0, cfg.vocab_size, 37).astype(np.int32)
    shared = [np.concatenate([system, rng.integers(0, cfg.vocab_size, int(n))
                              .astype(np.int32)]) for n in rng.integers(3, 40, 6)]
    shared.append(prompts[0])        # no shared prefix: a cold admission
    cold = run_engine(cfg_f, params, dev, ("cuda", "cuda"), shared, 12, **kw)
    runs = {
        "paged, warm": dict(prefix_blocks=16, warm=shared[:1]),
        "contiguous": dict(kv_layout="contiguous"),
        "contiguous, warm": dict(kv_layout="contiguous", prefix_blocks=16,
                                 warm=shared[:1]),
        "contiguous, warm, H=4": dict(kv_layout="contiguous", prefix_blocks=16,
                                      warm=shared[:1], decode_horizon=4),
        "auto, warm, forced paged": dict(kv_layout="auto", prefix_blocks=16,
                                         warm=shared[:1], force_paged=True),
        "auto, warm, forced paged, H=4": dict(kv_layout="auto", prefix_blocks=16,
                                              warm=shared[:1], force_paged=True,
                                              decode_horizon=4)}
    for label, extra in runs.items():
        got = run_engine(cfg_f, params, dev, ("cuda", "cuda"), shared, 12,
                         **{**kw, **extra})
        say(f"  {label}: tokens == cold paged: {got == cold}")
        if got != cold:
            raise AssertionError(f"{label}: {got} != {cold}")
    # copy-on-write: two resident requests share a prefix that ends inside a
    # cached block; the truncated one clones the block, and neither's
    # tokens move (nor a third serving's of the full prompt)
    template = rng.integers(0, cfg.vocab_size, 56).astype(np.int32)
    pair = [template, template[:40].copy()]
    want = run_engine(cfg_f, params, dev, ("cuda", "cuda"), pair, 12, **kw)
    got = run_engine(cfg_f, params, dev, ("cuda", "cuda"), pair, 12,
                     prefix_blocks=16, warm=[template], **kw)
    after = run_engine(cfg_f, params, dev, ("cuda", "cuda"), pair[:1], 12,
                       prefix_blocks=16, warm=pair, **kw)
    ok = got == want and after[0] == want[0]
    say(f"  copy-on-write tail shared by two resident requests: tokens "
        f"unchanged, and a later serving's of the full prompt: {ok}")
    if not ok:
        raise AssertionError(f"copy-on-write runs: {got}, {after} != {want}")


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
    16 steps, one over 4 steady speculative verify calls of span 4, and
    one over a 512-token prompt's four prefill chunks: the breakdown by
    kernel.  Its walls and idle shares hold the profiler's own
    cost (the unprofiled idle time is phase 4's steady window).  The device
    launches of the decode kernels must be 3 per step per layer, as in the
    profiled call of phases 4 and 4b."""
    from repro_torch.core import VPE
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request
    kw = dict(slots=SLOTS, max_len=MAX_LEN, block_size=BS, kv_layout="paged",
              prefill_chunk=CHUNK, decode_impl="cuda", prefill_kernel="cuda",
              device=dev, vpe=VPE())
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
    # four steady speculative verify calls of span 4 at 4 busy slots (a
    # cold table: each commits about a token a slot), graph replays
    eng = ContinuousBatchingEngine(cfg, params, decode_horizon=4, spec_draft=4, **kw)
    for i, p in enumerate(prompts[:SLOTS]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=400))
    while eng.num_decoding < SLOTS:
        eng.step()
    eng.step()                              # captures the verify graph
    st = eng.stats
    before = (st.spec_calls, st.decode_steps, eng.graphs.verify_captures)
    r = profiled(lambda: [eng.step() for _ in range(4)], "verify_4_calls", trace_dir)
    calls = st.spec_calls - before[0]
    r.update(verify_calls=calls,
             wall_us_per_call=r["wall_us"] / max(calls, 1),
             busy_us_per_call=r["busy_us"] / max(calls, 1))
    say(f"  verify_4_calls: {calls} verify calls, busy {r['busy_us_per_call']} us "
        f"and wall {r['wall_us_per_call']} us a call (profiled)")
    if calls != 4 or st.decode_steps - before[1] != 4 \
            or eng.graphs.verify_captures != before[2]:
        raise AssertionError("verify_4_calls: the window was not 4 steady verify "
                             "replays")
    out["verify_4_calls"] = r
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
    S < T, T off the tile, and the contiguous admission's prefill shapes
    (:data:`SERVE_FLASH_CASES`); then the gradient of ``attention_flash``
    (kernel forward) against autograd through ``attention_chunked``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import layers
    say("[3c] flash kernel against its plain version (B=1)")
    gen = torch.Generator(dev).manual_seed(6)
    err = 0.0
    cases = [(h, c) for h in FLASH_HEADS for c in FLASH_CASES] + [
        (SERVE_FLASH_HEADS, c) for c in SERVE_FLASH_CASES]
    for dtype in (torch.bfloat16, torch.float32):
        for (Hq, Hkv, D), (S, T, causal, window) in cases:
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
        for h, w, kh, kw in CONV_CHECKS:
            x = torch.randn((h, w), generator=gen, device=dev).to(dtype)
            taps = torch.randn((kh, kw), generator=gen, device=dev).to(dtype)
            got = kconv.conv2d(x, taps)
            if got.shape != (h - kh + 1, w - kw + 1):
                raise AssertionError(f"conv2d {h}x{w}*{kh}x{kw}: shape {tuple(got.shape)}")
            err = check_close(f"conv2d {dname} {h}x{w} * {kh}x{kw}", got,
                              ref.conv2d_ref(x, taps), *conv_tolerance(dtype))
            if dtype == torch.bfloat16 and not torch.equal(
                    got, kconv.conv2d(x.float(), taps.float()).to(dtype)):
                raise AssertionError(f"conv2d bf16 {h}x{w}*{kh}x{kw}: not the f32 sums "
                                     f"rounded once")
            errors["conv2d"][dname] = max(errors["conv2d"].get(dname, 0.0), err)
    for hw, k in CONV_TIMES:
        x = torch.randn((hw, hw), generator=gen, device=dev)
        taps = torch.randn((k, k), generator=gen, device=dev)
        fixed = kconv.CONV_TAPS.index((k, k))
        want = kconv.launch(x, taps, 0, 0)
        for t in (0, fixed):
            for tile in range(len(kconv.CONV_TILES)):
                if not torch.equal(kconv.launch(x, taps, t, tile), want):
                    raise AssertionError(f"conv2d {hw}^2 * {k}x{k} f32: taps "
                                         f"{kconv.CONV_TAPS[t]}, tile {tile} differ from "
                                         f"the runtime size on tile 0")
        say(f"  conv2d {hw}^2 * {k}x{k} f32: the {k}x{k} and runtime-size "
            f"instantiations on both tiles equal bit for bit")
    torch.cuda.synchronize()
    say(f"  worst errors: {errors}")
    return errors


def phase_paper_kernel_times(dev):
    """matmul and conv2d at the paper path's shapes, f32, and conv2d at
    4096^2 * 5x5: kernel, plain version and one library call
    (``torch.matmul``, ``F.conv2d``, both with TF32 off; timed only, never
    called by the port) timed with L2 flushed, the bound computed; for
    conv2d also the kernel's device time from torch.profiler, beside the
    launch floor.  Keys "matmul" and "conv2d" hold the Table-1
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
    for hw, k in CONV_TIMES:
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
    # the launch floor: one kernel that does nearly nothing (a one-element
    # fill), timed as the kernels below are
    one = torch.empty(1, device=dev)
    floor_ms = device_ms(lambda: one.fill_(1.0), flush)
    say(f"  launch floor (a one-element fill, timed as below): {floor_ms} ms")
    times = {"launch floor": floor_ms}
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
        if r["name"] == "conv2d":
            kernel_ms = profiled_kernel_ms(r["kernel"], flush, "conv2d_kernel")
            times[shape].update(profiled_ms=kernel_ms, bound_share=bound_ms / ms,
                                launch_floor_ms=floor_ms)
            say(f"    device time of conv2d_kernel a call (torch.profiler, median of "
                f"the last 20 of 30): {kernel_ms if kernel_ms is not None else 'not measured'} ms; "
                f"share of the bound {bound_ms / ms} (events), "
                f"{bound_ms / kernel_ms if kernel_ms else 'not measured'} (profiler); "
                f"events minus profiler "
                f"{ms - kernel_ms if kernel_ms is not None else 'not measured'} ms; "
                f"launch floor {floor_ms} ms; kernel/floor {ms / floor_ms}")
    times["matmul"] = times["matmul 512^3"]
    times["conv2d"] = times["conv2d 512^2 * 5x5"]
    del flush
    return times


def profiled_kernel_ms(fn, flush, name, iters=20, warmup=10):
    """Median device time, in ms, of the kernel whose name holds ``name``,
    read from torch.profiler over the last ``iters`` of ``warmup + iters``
    calls of ``fn`` made as :func:`device_ms` makes them (L2 flushed before
    each); None unless the profiler shows that many.  Late in this script
    the profiler has shown only 15 kernels of 20 calls in a session, hence
    the calls beyond the measured ones."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(warmup + iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and name in e.name)
    if len(spans) < iters:
        say(f"    profiler: {len(spans)} {name} events of {warmup + iters} calls")
        return None
    return float(np.median([us for _, us in spans[-iters:]])) / 1e3


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
    main_logits = main_run.pop("first_logits")
    fused = phase_fused_horizons(cfg, params, dev, prompts, main_run)
    fused.pop("first_logits")
    auto = phase_auto_horizon(cfg, params, dev, prompts, main_run)
    prefix, cold_4d = phase_prefix_cache(cfg, params, dev)
    layouts = phase_layouts(cfg, params, dev, prompts, main_run, main_logits, cold_4d)
    pressure = phase_pressure(cfg, params, dev, prompts, main_run, main_logits)
    spec = phase_speculation(cfg, params, dev, prompts, main_run, main_logits)
    faults = phase_faults(cfg, params, dev, prompts, main_run, main_logits)
    del main_logits, cold_4d
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
                 fused_horizons=fused, auto_horizon=auto, prefix_cache=prefix,
                 layouts=layouts, pressure=pressure, speculation=spec,
                 faults=faults,
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
