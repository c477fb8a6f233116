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
   (paged kernels at qwen3-8b's head shapes and at qwen2-moe-a2.7b's, a
   group of 1; the flash kernel at h2o-danube-3-4b's, qwen3-8b's and
   qwen2-moe-a2.7b's, the training path's 4096 tokens among them, and the
   autograd wiring of its gradient; the flash backward kernel's bf16
   gradients against the f32 VJP of ``attention_chunked`` at danube's,
   zamba2's, whisper's and a split rank's heads), bf16 (the tensor-core
   bodies of flash and prefill) and f32 (CUDA-core bodies); then, at the
   shapes its path gives it, its time beside its plain version's, one
   PyTorch library call's (timed only: the port never calls it) and its
   bound, and the decode kernel's time at qwen2-moe-a2.7b's heads;
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
14. replicas: (a) phase 4's engine settings as a group of two replicas on
   one card (``make_serve_engine(mesh_shape=(2, 1), mesh_devices=["cuda:0",
   "cuda:0"])``, one copy of the weights), 16 requests (phase 4's 8 and 8
   more from the same generator), each replica warmed by a request of its
   own, launch counts zeroed just before the timed run and read just after
   (the kernels line gives them under ``launches_by_path``, beside phase
   4's, 15a's and the others); printed per replica: admits,
   captures, replays, pool bytes; for the group: TTFT, decode tok/s, the
   group step's host wall, peak memory; gates: every request done, each
   replica admitting at least 4, the pools drained, no capture in the run,
   the launches one a layer a step or chunk, a single engine's tokens on
   the same 16 requests or a parting at a near-tie (top-2 margin <= 0.25),
   and the shared VPE's keys labelled ``xmesh:dp2mp1``; (b) failover on
   reduced qwen3-8b in f32, the group of two on one card, device faults at
   replica 0's decode calls and one lost dispatch, a replica budget of 2:
   a quarantine and a re-admission, no canary in ``completed``, every
   request done with a clean single engine's tokens, no failure;
15. head sharding, after phase 14 once the parent has freed its model:
   (a) full-width qwen3-8b in bf16 at mesh (1, 2), two rank processes
   (``spawn_ranks``) on ``cuda:0`` over gloo, each with 16/4 heads and half
   the FFN, on phase 4's engine settings and requests (eager: a sharded
   rank replays no graph), launch counts zeroed just before the run and
   read just after on each rank; gates: every request done, both paged
   kernels launched one a layer a step or chunk on each rank, no rank's
   own tokens differing from rank 0's, the pools drained, phase 4's
   tokens or a parting at a near-tie (top-2 margin <= ``SHARD_TIE``);
   printed per rank: decode-only step wall, decode tok/s, TTFT, peak
   memory; (b) both paged kernels at the shards' heads (16/4 and 8/2)
   against their plain versions; (c) reduced qwen3-8b in f32 at (1, 2)
   and (1, 4), token for token one engine's, both kernels launched on
   every rank (at (1, 4) one query and one KV head a rank);
12. the MoE path: full-width qwen2-moe-a2.7b, all 24 layers in bf16
   (random weights from a seeded generator on the card; weights, pool and
   peak memory printed), on phase 4's engine and traffic: (a) H = 1 with
   phase 4's gates and steady window; (b) H = 16, tokens (a)'s request by
   request; (c) speculation at S = 4, the traffic twice, verify replays,
   pass 2 accepting more, tokens (a)'s or parting at a near-tie (margins
   from the served chunks: an MoE layer's capacity depends on the rows
   routed together); (d) first-step prefill and decode logits, cuda vs
   gather, within 0.25 with the gather path's routing replayed (the rows
   routed elsewhere and the unpinned difference printed); (e) reduced
   qwen2-moe-a2.7b and moonshot-v1-16b-a3b in f32, token for token:
   kernels against the gather path, H = 4 and 16 against 1, S = 4 against
   H = 1, paged against contiguous against ``auto`` (prompts whose rows
   route without a drop); (f) training at full width and 2 layers, 1 x
   4096 tokens, ``flash_cuda`` pinned, 3 steps: finite losses, 2 flash
   launches a layer a step;
13. the recurrent and encoder-decoder families, each model freed before
   the next: (a) zamba2-1.2b, (b) rwkv6-7b and (c) whisper-base at full
   width in bf16 (random weights from a seeded generator on the card;
   weights, cache and peak bytes printed), two waves of 4 requests on
   ``ServeLoop(batch=4)`` + ``WaveScheduler`` (whisper: ``generate`` with
   seeded frames), 32 new tokens each, ``flash_cuda`` pinned where there
   is attention; printed: prefill s, decode tok/s, the decode wall a step
   and the flash launches (zeroed just before the run): 6 a prefill for
   zamba2, 18 for whisper, none for rwkv6; gates: tokens in range,
   first-step logits ``flash_cuda`` against ``reference`` within 0.25,
   and (zamba2, rwkv6) prefill against a step-by-step decode replay of
   wave 1 on the same weights in f32 within 2e-2 (the bf16 difference
   printed); (d) the flash kernel at these families' shapes (head_dim 64,
   causal and non-causal, S < T and S > T) against its plain version,
   bf16 and f32, and its time at zamba2's training shape and whisper's
   encoder beside the plain version's, one SDPA call's and the bound; (e)
   the reduced configs in f32 (zamba2 also with a mamba tail): tokens
   equal across ``attn_impl`` (rwkv6: ``wkv_impl``), prefill against the
   decode replay; (f) training at 1 x 4096 tokens, 3 steps: zamba2-1.2b at
   full width (12 flash launches a step) and rwkv6-7b at full width cut
   to 2 layers, and one whisper-base ``loss_fn`` backward with frames (36
   flash launches): finite losses and gradients;
7. training path: full h2o-danube-3-4b, all 24 layers (bf16 params, f32
   master/m/v, 1 x 4096 tokens, remat), trained by ``TrainLoop``: first
   with the VPE free until it concludes its ``attn_impl`` trial, then with
   ``flash_cuda`` pinned, the flash launch counts zeroed just before those
   steps and read just after (2 forward and 1 backward launches a layer a
   step); then a full-size checkpoint save and
   restore of the params, the f32 master copy and the step (23.8 GB),
   every leaf zeroed before the restore and compared bit for bit after it
   (m and v stay out: the whole state, 55.5 GB, would pass the 45 GiB this
   script may write to disk);
8. training parity: reduced h2o-danube-3-4b in f32, loss and gradients
   and three loop steps of ``flash_cuda`` against ``reference``;
16. training on the (data, model) mesh, after phase 8 with no model held:
   full-width h2o-danube-3-4b cut to ``MESH_LAYERS`` layers (so that four
   ranks' training state fits the card, and the script its time),
   ``flash_cuda`` pinned, at (1, 1) in this process and at (2, 1), (1, 2)
   and (2, 2) as rank processes
   (``spawn_ranks``) on ``cuda:0`` over gloo, each rank's bytes reckoned
   and printed first; (a) f32, global batch 2 x 1024, 3 steps, the flash
   launch counts zeroed just before them and read just after on every
   rank; gates: losses and grad norms within ``MESH_LOSS_REL`` /
   ``MESH_GNORM_REL`` of (1, 1)'s, a leaf no rank splits bit-equal on
   every rank and every leaf on every data rank, 2 flash launches a layer
   a step on every rank (the kernels line's ``launches_by_path``); (b)
   bf16, 2 x 4096, 1 warm-up and 2 timed steps; gate: every rank's
   losses within ``MESH_BF16_LOSS_REL`` of (1, 1)'s; printed per rank:
   step seconds (the slowest rank's), tokens/s of the mesh, peak memory
   (and the peak while the loop is built, each rank drawing only its
   slice; both above what was allocated before), the µs of the gradient
   all-reduce (the rank's whole sync) and of one activation all-reduce
   (2 x 4096 x 3840 f32 over the model group); (c) ``compressed_psum``
   over the 4 ranks of (2, 2), a CUDA tensor against its CPU copy: 0
   apart, and within 4 int8 steps of the agreed scale; (d) (a) and (b)
   with fsdp at (2, 1) and (2, 2) (``TrainLoop(..., fsdp=True)``: params
   and optimizer state cut over ``data`` as well, a layer's slices
   all-gathered where it is read, its gradient reduce-scattered), under
   (a)'s and (b)'s gates against the same (1, 1) runs, and the µs a step
   of the all-gathers and reduce-scatters (the host wall of each call);
17. the dry run against the card (``repro_torch.launch.dryrun`` on the
   meta device): (a) every rank's build peak of 16b and 16d within
   [the dry run's state bytes a rank, + ``MESH_BUILD_SLACK``]; (b) the
   (1, 1) bf16 step's measured peak beside the dry run's state,
   gradients and saved-for-backward bytes, and its measured seconds
   beside the roofline's ``step_s`` (the share printed); (c) the fsdp
   meshes' counted collective bytes beside 16d's measured µs; (d) the
   40-cell sweep ``--no-probes`` at (16, 16), in ``SWEEP_WORKERS`` processes
   on the host, run after phase 11 so that no timed phase shares the host with
   it: its count of ok, skipped and error cells; any count but
   ``SWEEP_COUNTS`` (33 ok, 7 skipped, 0 error), or a sweep not done in
   ``SWEEP_TIMEOUT_S``, fails the phase;
18. the recurrent and encoder-decoder families on the (data, model) mesh,
   after phase 17 with no model held, every rank a process on ``cuda:0``
   over gloo, the (1, 1) references in this process: the flash kernel at
   a rank's heads (zamba2's shared block at 16/16 heads, whisper's 4/4)
   against its plain version, bf16 and f32; (a) zamba2-1.2b at full width
   and depth, flash pinned, f32 2 x 1024 for 2 steps at (1, 1), (1, 2),
   (2, 2) and bf16 1 x 4096 (1 warm-up, 2 timed steps) at (1, 1), (1, 2);
   (b) rwkv6-7b at full width cut to 4 layers, f32, at (1, 1), (1, 2),
   (1, 4); (c) whisper-base whole, f32 2 x 256 tokens against 1500 seeded
   frames, at (1, 1), (1, 2); gates as phase 16's (f32 losses and grad
   norms within ``MESH_LOSS_REL``, bf16 losses within
   ``MESH_BF16_LOSS_REL`` of (1, 1)'s, replicas bit-equal at (2, 2), 2
   flash launches an attention a step on every rank), the (1, 2) bf16
   build peak within [the dry run's state, + ``MESH_BUILD_SLACK``];
   printed per rank: step seconds, peak memory, the gradient sync's and an
   activation all-reduce's µs; (d) lockstep ``prefill`` and 16 greedy
   ``decode_step``s of the three at full width, bf16, 4 rows of 120-512
   prompt tokens (whisper: 256 against 1500 frames), at (1, 2) against
   (1, 1): tokens equal, or parting only where (1, 1)'s top-2 margin is at
   most ``TIE_MARGIN``; the reduced configs in f32 at (1, 2) and (1, 4)
   token for token; one flash launch an attention of each prefill on
   every rank;
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
replays) and one prompt's prefill chunks of qwen3-8b, phase 12's profile
of 8 steady decode steps of qwen2-moe-a2.7b (expert GEMMs apart), both in
a child process of their own (:func:`in_child`: late in a long process
the profiler loses the first records of a window), and one profiled
training step in phase 7 (device busy share, time by kernel, the
profiler's own cost included), and writes the chrome traces there,
gzipped.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import gzip
import json
import os
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

# the MoE path (phase 12): full-width qwen2-moe-a2.7b served by phase 4's
# engine; its heads (Hq = Hkv = 16, D = 128: a group of 1) checked and
# timed in phase 3; trained at full width and 2 layers
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_HEADS = (16, 16, 128)
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 3
# reduced MoE parity (phase 12e): the reduced configs of both MoE archs
MOE_PARITY_ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")

# the training path: full h2o-danube-3-4b at 1 x 4096 tokens
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "h2o-danube-3-4b", 1, 4096, 4
# flash kernel checks: (Hq, Hkv, D) of h2o-danube-3-4b, qwen3-8b and
# qwen2-moe-a2.7b, and
# (S, T, causal, window): S = T, S < T, T off the 64-key tile, and the
# training path's own shape
FLASH_HEADS = ((32, 8, 120), (32, 8, 128), MOE_HEADS)
FLASH_CASES = ((2048, 2048, True, None), (2048, 2048, True, 1024),
               (2048, 2048, False, None), (2048, 2048, False, 1024),
               (300, 1100, True, 1024), (1000, 1000, True, 4096),
               (TRAIN_SEQ, TRAIN_SEQ, True, 4096))
# flash backward checks (phase 3c): (heads, (S, T, causal, window)) at
# danube's heads (a window under S; the training path's shape), zamba2's
# D = 64 causal at 32/32 heads, whisper-base's non-causal encoder and its
# cross-attention (S != T), and a head split at mp = 2 (16/4)
FLASH_BWD_CASES = (((32, 8, 120), (1024, 1024, True, 512)),
                   ((32, 8, 120), (TRAIN_SEQ, TRAIN_SEQ, True, 4096)),
                   ((32, 32, 64), (1024, 1024, True, None)),
                   ((8, 8, 64), (1500, 1500, False, None)),
                   ((8, 8, 64), (256, 1500, False, None)),
                   ((16, 4, 120), (1000, 1000, True, None)))
# the bf16 backward against the f32 VJP, relative distance of each gradient
# (its norm): rounding the gradients to bf16 alone gives ~2.3e-3 (CPU
# tests), the kernel's P and dS roundings ~1e-4 more; a lost tile or a
# wrong mask gives O(1)
FLASH_BWD_REL = 1e-2
# the backward kernel against its plain version (the same algorithm, the
# same bf16 roundings of P and dS), (atol, rtol): both sum in f32 and round
# once to bf16, so the gradients may sit one bf16 step apart (2^-7 of the
# value); the atol covers gradients near 0, where a rounding of P or dS to
# the other bf16 neighbour (exp2 against ex2.approx) moves a sum by more
FLASH_BWD_TOL = (2e-2, 2 ** -7)
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
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "conv2d": "src/repro_torch/kernels/csrc/conv2d.cu",
}
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/paged_attention.py:352",
    "paged_prefill_attention": "src/repro/kernels/paged_attention.py:268",
    "flash_attention": "src/repro/kernels/flash_attention.py:105",
    "flash_attention_bwd": "none: src/repro/models/layers.py:149 (_flash_cvjp_bwd, plain VJP)",
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

def pool_inputs(gen, dtype, n_pages, S, B, hq=HQ, hkv=HKV):
    import torch
    dev = gen.device
    q = torch.randn((B, hq, S, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_pages, hkv, BS, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n_pages, hkv, BS, D), generator=gen, device=dev).to(dtype)
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

def decode_work(bt, lengths, window, elem, hq=HQ, hkv=HKV):
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
    nbytes = (2 * len(pages) * hkv * BS * D * elem + 2 * B * hq * D * elem
              + B * NB * 4 + B * 4)
    return nbytes, 4 * D * hq * cols


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


def profile_window(fn):
    """Run ``fn`` under torch.profiler (CPU and CUDA activities), fenced.
    Returns (the profile, fn's wall in us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


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
    """Every kernel against its plain version, bf16 and f32 pools, at
    qwen3-8b's heads (a group of 4) and qwen2-moe-a2.7b's (a group of 1:
    three of the decode block's four query rows are padding)."""
    import torch
    say("[3] kernels against their plain versions (D=128, bs=16, nb=64; "
        f"qwen3-8b heads Hq={HQ}, Hkv={HKV}, and {MOE_ARCH} heads "
        f"Hq={MOE_HEADS[0]}, Hkv={MOE_HEADS[1]})")
    gen = torch.Generator(dev).manual_seed(3)
    errors = {"paged_decode_attention": 0.0, "paged_prefill_attention": 0.0}
    check_paged_kernels(gen, ((HQ, HKV), MOE_HEADS[:2]), errors)
    return errors


def check_paged_kernels(gen, heads, errors):
    """Both paged kernels against their plain versions at each (Hq, Hkv) of
    ``heads``, bf16 and f32 pools, with and without a window (decode: and
    ``read_dtype``); the largest error of each kernel goes into
    ``errors``."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    dev = gen.device
    n_pages = 4 * NB
    for hq, hkv in heads:
        for dtype in (torch.bfloat16, torch.float32):
            for window in (None, 100):
                for read_dtype in (None, torch.bfloat16):
                    B = 4
                    q, kp, vp = pool_inputs(gen, dtype, n_pages, 1, B, hq, hkv)
                    bt = shared_tables(gen, B, n_pages)
                    lengths = torch.randint(0, NB * BS, (B,), generator=gen,
                                            device=dev, dtype=torch.int32)
                    got = pa.paged_attention_cuda(q, kp, vp, bt, lengths,
                                                  window=window, read_dtype=read_dtype)
                    want = ref.paged_attention_ref(q, kp, vp, bt, lengths,
                                                   window=window, read_dtype=read_dtype)
                    torch.cuda.synchronize()
                    name = (f"decode Hq={hq} Hkv={hkv} {str(dtype)[6:]} window={window} "
                            f"read_dtype={str(read_dtype)[6:] if read_dtype else None}")
                    err = check_close(name, got, want, *tolerance(dtype, read_dtype))
                    errors["paged_decode_attention"] = max(
                        errors["paged_decode_attention"], err)
            for C, window in ((16, None), (128, None), (512, None), (128, 100)):
                B = 2
                q, kp, vp = pool_inputs(gen, dtype, n_pages, C, B, hq, hkv)
                bt = shared_tables(gen, B, n_pages)
                base = torch.randint(1, NB * BS - C + 1, (B,), generator=gen,
                                     device=dev, dtype=torch.int32)
                chunk_len = C - 5
                got = pa.paged_prefill_attention_cuda(q, kp, vp, bt, base,
                                                      chunk_len=chunk_len, window=window)
                want = ref.paged_prefill_attention_ref(q, kp, vp, bt, base,
                                                       chunk_len=chunk_len,
                                                       window=window)
                torch.cuda.synchronize()
                name = (f"prefill Hq={hq} Hkv={hkv} {str(dtype)[6:]} C={C} "
                        f"chunk_len={chunk_len} base={base.tolist()} window={window}")
                err = check_close(name, got, want, *tolerance(dtype, None))
                errors["paged_prefill_attention"] = max(
                    errors["paged_prefill_attention"], err)


def decode_timing_case(gen, prompt_lens, hq=HQ, hkv=HKV):
    """Decode at the main path's shapes (at ``hq``/``hkv`` heads): every
    slot mid-way through its new tokens, each slot its own pages, the
    read_dtype body the engine runs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.kvcache import paged_gather_layer
    dev, dt = gen.device, torch.bfloat16
    n_pages = SLOTS * NB + SLOTS + 1
    q, kp, vp = pool_inputs(gen, dt, n_pages, 1, SLOTS, hq, hkv)
    bt = distinct_tables(gen, SLOTS, n_pages)
    lengths = torch.tensor([p + NEW_TOKENS // 2 for p in prompt_lens[:SLOTS]],
                           dtype=torch.int32, device=dev)
    # the library call's input, K/V linearised through the tables (not timed)
    kg, vg = paged_gather_layer(kp, vp, bt)
    col = torch.arange(NB * BS, device=dev)
    mask = (col[None, :] <= lengths[:, None].long())[:, None, None, :]
    return dict(
        shape=f"B={SLOTS} Hq={hq} Hkv={hkv} lengths={lengths.tolist()}",
        kernel=lambda: pa.paged_attention_cuda(q, kp, vp, bt, lengths,
                                               read_dtype=dt),
        plain=lambda: ref.paged_attention_ref(q, kp, vp, bt, lengths,
                                              read_dtype=dt),
        library=lambda: F.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask, enable_gqa=True),
        work=decode_work(bt, lengths, None, 2, hq, hkv))


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
    splits1, kps1 = pa.decode_split_plan(SLOTS, MOE_HEADS[1], NB, BS,
                                         build.sm_count(dev))
    say("[3b] kernel times at the main path's shapes (bf16, median of 20 "
        "calls, L2 flushed before each); decode: grid of "
        f"{splits} splits of {kps} keys x {HKV} KV heads x {SLOTS} sequences, "
        "3 device launches a call (stats pass, value pass, combine); at "
        f"{MOE_ARCH}'s heads (g1) {splits1} splits of {kps1} keys x "
        f"{MOE_HEADS[1]} KV heads")
    gen = torch.Generator(dev).manual_seed(4)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)  # 256 MB
    # the MoE path's decode (a group of 1) is a row of its own: the kernels
    # line holds the main path's shapes
    rows = {"paged_decode_attention": decode_timing_case(gen, prompt_lens),
            "paged_prefill_attention": prefill_timing_case(gen),
            "paged_decode_attention_g1": decode_timing_case(
                gen, prompt_lens, *MOE_HEADS[:2])}
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


def traffic(vocab: int, seed: int = 0, more: int = 0):
    """The main path's prompts (64–512 tokens), then ``more`` drawn after
    them from the same generator (phase 14a's traffic: the first 8 are
    phase 4's)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 513, REQUESTS)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]
    if more:
        lens = rng.integers(64, 513, more)
        prompts += [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]
    return prompts


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


# fills ahead of a profiled window in this process (:func:`steady_window`):
# more than the records a late session has lost at a window's start (8-10
# in tools/trace_loss.py, between 33 and about 130 in one --trace run, and
# at least 1,081 once in phase 12b)
PREFIX_FILLS = 4096


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
    # late in a long process a profiler session loses a prefix of its
    # window's device records (PERF.md section 7): one-element fills ahead
    # of the step take that loss, and no fill is a decode kernel
    fill = torch.empty((1,), device=graphs.device)
    prof, _ = profile_window(lambda: ([fill.fill_(0) for _ in range(PREFIX_FILLS)],
                                      engine.step()))
    profiled_steps = st.decode_steps - steps0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    launches = sum(1 for e in device if kernel_group(e.name) == "paged decode kernels")
    fills = sum(1 for e in device if "fill" in e.name.lower())
    out.update(profiled_steps=profiled_steps, profiled_decode_launches=launches,
               profiled_fills=fills)
    say(f"  steady window (4 slots decoding, unprofiled): {calls} calls, {steps} "
        f"steps, wall {out['wall_us_per_step']} us a step, device span of the "
        f"replays {out['span_us_per_step']} us a step (CUDA events), idle "
        f"{out['idle_us_per_step']} us a step, idle share {out['idle_share']}; one "
        f"profiled call: {profiled_steps} steps, device launches of the paged "
        f"decode kernels {launches} (expected {3 * profiled_steps * cfg.num_layers}), "
        f"fill records {fills} ({PREFIX_FILLS} fills ahead, and the step's own)")
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


def first_difference(label, main, run, ref_label="phase 4"):
    """Raise unless each request's tokens in ``run`` are ``main``'s."""
    differ = [rid for rid, toks in main["tokens"].items() if run["tokens"][rid] != toks]
    say(f"  tokens equal to {ref_label}'s (H = 1), request by request: {not differ}")
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


def served_logits(cfg, params, seq):
    """The logits after ``seq``, prefilled by a new engine on the gather
    path in the main path's 128-token chunks."""
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request
    eng = ContinuousBatchingEngine(
        cfg, params, slots=1, max_len=MAX_LEN, block_size=BS, kv_layout="paged",
        prefill_chunk=CHUNK, decode_impl="grouped", prefill_kernel="gather",
        device=params["embed"].device)
    eng.first_logits = {}
    eng.submit(Request(rid=0, prompt=seq, max_new_tokens=1))
    eng.run()
    return eng.first_logits[0].float()


def token_margin(cfg, params, prompt, before, a, b):
    """Where two runs part: the logits after the prompt and the tokens
    before that position; logit[a] - logit[b] there, and the top-2 margin.
    A dense model's come from a full forward.  An MoE model's come from
    the serving path's own chunks (:func:`served_logits`): an MoE layer's
    capacity depends on the tokens routed together, and a whole-sequence
    forward can drop assignments the served chunks did not."""
    import torch
    from repro_torch.models import model as model_lib
    seq = np.concatenate([prompt, np.asarray(before, np.int32)])
    if cfg.family == "moe":
        logits, via = served_logits(cfg, params, seq), "served chunks"
    else:
        with torch.no_grad():
            logits = model_lib.forward(cfg, params, {"tokens": torch.from_numpy(
                seq[None]).to(params["embed"].device)})[0, -1]
        via = "full forward"
    top2 = torch.topk(logits, 2).values
    return dict(a_minus_b=float(logits[a] - logits[b]),
                top2_margin=float(top2[0] - top2[1]), via=via)


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
            f"{p['top2_margin']}, {p['via']})" for p in parts))
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


def phase_speculation(cfg, params, dev, prompts, main, main_logits, spans=(4, 16),
                      tag="4g", ref_label="phase 4"):
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
    say(f"[{tag}] speculation: {cfg.name} at full width, {ref_label}'s engine, "
        f"decode_horizon = spec_draft = S, {ref_label}'s traffic twice on one engine")
    out = {}
    for S in spans:
        engine = serving_engine(cfg, params, dev, S, spec_draft=S)
        passes = []
        for k in range(2):
            label = f"phase {tag} S={S} pass {k + 1}"
            # the verify read is the gather path: a pass whose every step
            # speculates launches no decode kernel, so only the prefill
            # kernel is required (decode launches are printed)
            run = serve_traffic(engine, cfg, prompts, label, rid0=100 * (k + 1),
                                kernels=("paged_prefill_attention",), idle=True)
            say_spec(label, run)
            run["compare"] = compare_runs(label, ref_label, ref, run, cfg, params,
                                          prompts, tie=TIE_MARGIN)
            run.pop("first_logits")
            passes.append(run)
        cold, warm = passes
        if warm["captures_in_run"] or warm["verify_captures_in_run"]:
            raise AssertionError(f"phase {tag} S={S}: a capture in pass 2")
        if not (cold["verify_replays_in_run"] and warm["verify_replays_in_run"]):
            raise AssertionError(f"phase {tag} S={S}: no verify replay in a pass")
        if not warm["spec"]["accept_rate"] > (cold["spec"]["accept_rate"] or 0.0):
            raise AssertionError(f"phase {tag} S={S}: pass 2's accept rate "
                                 f"{warm['spec']['accept_rate']} is not above pass "
                                 f"1's {cold['spec']['accept_rate']}")
        out[S] = passes
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    say(f"  phase {tag} wall {wall} s")
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


class RoutingLog:
    """Installed on ``repro_torch.models.moe`` for one run, then removed:
    records the experts of every ``route`` call, or, given the calls of
    another run, replays them — each call then takes the recorded experts
    and weighs them by its own gates, renormalised as ``route`` does."""

    def __init__(self, replay=None):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe.route
        self.calls = []
        self.replay = iter(replay) if replay is not None else None
        moe.route = self.route

    def route(self, s, router_w, x):
        import torch
        if self.replay is None:
            weights, experts = self.real(s, router_w, x)
        else:
            experts = next(self.replay)
            gates = torch.softmax(x.float() @ router_w.float(), dim=-1)
            weights = torch.gather(gates, -1, experts)
            if s.norm_topk_prob:
                weights = weights / torch.sum(weights, dim=-1, keepdim=True)
        self.calls.append(experts)
        return weights, experts

    def remove(self):
        self.moe.route = self.real


def routing_flips(a, b, real):
    """(rows whose expert set differs between two runs' route calls, rows):
    the first ``real[i]`` rows of call i, its tokens that are not padding."""
    differ = sum(int((x[:r].sort(-1).values != y[:r].sort(-1).values).any(-1).sum())
                 for x, y, r in zip(a, b, real, strict=True))
    return differ, sum(real)


def phase_full_width_parity(cfg, params, dev, prompts, atol, tag="5b"):
    """First-step prefill and decode logits, the kernels' path (cuda) against
    the gather path, within ``atol``.  An MoE model's routing is discrete:
    where a row's k-th and (k+1)-th gates nearly tie, the two paths'
    roundings can send it to another expert, and the logits then move by
    more than the kernels' error.  So for MoE the unpinned difference and
    the rows routed elsewhere are printed, and the gate holds the kernels'
    path run again with the gather path's routing replayed
    (:class:`RoutingLog`)."""
    import torch
    moe = cfg.family == "moe"
    log = RoutingLog() if moe else None
    ref_pre, ref_dec, toks = first_step_logits(cfg, params, dev, prompts,
                                               "gather", "grouped")
    if moe:
        log.remove()
        free = RoutingLog()
    got_pre, got_dec, _ = first_step_logits(cfg, params, dev, prompts, "cuda",
                                            "cuda", tokens=toks)
    gated = {"prefill": got_pre, "decode": got_dec}
    flips = None
    if moe:
        free.remove()
        # first_step_logits' route calls: each chunk of each prompt, then
        # the decode step, one a layer
        real = [min(CHUNK, len(p) - base) for p in prompts
                for base in range(0, len(p), CHUNK) for _ in range(cfg.num_layers)]
        real += [len(prompts)] * cfg.num_layers
        flips = routing_flips(log.calls, free.calls, real)
        pinned = RoutingLog(replay=log.calls)
        pin_pre, pin_dec, _ = first_step_logits(cfg, params, dev, prompts, "cuda",
                                                "cuda", tokens=toks)
        pinned.remove()
        gated = {"prefill": pin_pre, "decode": pin_dec}
        say(f"[{tag}] {cfg.name}: {flips[0]} of {flips[1]} routed rows chose other "
            f"experts on the kernels' path than on the gather path (padding "
            f"rows left out)")
    torch.cuda.synchronize()
    out = {}
    for what, want, got in (("prefill", ref_pre, got_pre), ("decode", ref_dec, got_dec)):
        if not (torch.isfinite(want).all() and torch.isfinite(got).all()
                and torch.isfinite(gated[what]).all()):
            raise AssertionError(f"{what} logits are not finite")
        err = float((got - want).abs().max())
        gate_err = float((gated[what] - want).abs().max())
        same = torch.argmax(got, -1) == torch.argmax(want, -1)
        top2 = torch.topk(want, 2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).tolist()
        say(f"[{tag}] {cfg.name} full width bf16 {what} logits, cuda vs gather: "
            f"max abs diff {err}"
            + (f", {gate_err} with the gather path's routing replayed" if moe else "")
            + f" (tolerance {atol}), logit scale {float(want.abs().max())}, "
            f"argmax equal {same.tolist()}, reference top-2 margins {margins}")
        if not bool(same.all()):
            b = int((~same).nonzero()[0])
            say(f"  first sequence whose argmax differs: {b}, reference top-2 "
                f"margin {margins[b]}")
        if gate_err > atol:
            raise AssertionError(f"{what} logits differ by {gate_err} > {atol}")
        out[what] = dict(max_abs_diff=err, gated_max_abs_diff=gate_err,
                         argmax_equal=same.tolist(), top2_margin=margins,
                         routing_flips=flips)
    return out


# kernel-name groups of a trace, first match wins (lower-case keys)
KERNEL_GROUPS = (("paged decode kernels", ("paged_decode",)),
                 ("paged prefill kernel", ("paged_prefill_kernel",)),
                 ("flash forward kernel", ("flash_fwd_kernel",)),
                 ("flash backward kernels", ("flash_bwd",)),
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


EXPERT_GROUP = "expert GEMMs"


def profiled(fn, label, trace_dir, ranges=(), experts=None):
    """Run ``fn`` under torch.profiler (:func:`profile_window`); print its
    wall, the device's busy share of it, the device time by kernel and by
    kernel group, and the span on the device timeline of each named
    ``record_function`` range (summed over its occurrences).  ``experts``:
    the (kernel name, grid) pairs of the MoE expert products
    (:func:`expert_gemm_kernels`), counted under :data:`EXPERT_GROUP`.
    Returns a summary."""
    from torch.autograd import DeviceType
    prof, wall_us = profile_window(fn)
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
    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / f"trace_{label}.json.gz"
    prof.export_chrome_trace(str(path))
    with gzip.open(path, "rt") as f:
        trace = json.load(f)["traceEvents"]
    grids = {}
    for e in trace:
        if e.get("cat") == "kernel":
            grids.setdefault(e["name"], set()).add(tuple(e.get("args", {}).get("grid", ())))
    say(f"  trace {label}: wall {wall_us} us, device busy {busy_us} us "
        f"({busy_us / wall_us} of the wall; idle share {1 - busy_us / wall_us}), "
        f"{sum(n for n, _ in by_name.values())} device events")
    for name, (n, us) in top:
        say(f"    {us} us in {n} calls ({us / busy_us if busy_us else 0} of busy), "
            f"grids {sorted(grids.get(name, ()))[:3]}: {name[:100]}")
    groups, counts = {}, {}
    for name, (n, us) in by_name.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + us
        counts[kernel_group(name)] = counts.get(kernel_group(name), 0) + n
    if experts:
        for e in trace:
            grid = tuple(e.get("args", {}).get("grid", ()))
            if e.get("cat") == "kernel" and (e["name"], grid) in experts:
                g = kernel_group(e["name"])
                groups[g] -= e["dur"]
                counts[g] -= 1
                groups[EXPERT_GROUP] = groups.get(EXPERT_GROUP, 0.0) + e["dur"]
                counts[EXPERT_GROUP] = counts.get(EXPERT_GROUP, 0) + 1
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        say(f"    group {group}: {us} us in {counts[group]} events "
            f"({us / busy_us if busy_us else 0} of busy)")
    # a range's span on the device timeline, summed over its occurrences
    in_range = {r: 0.0 for r in ranges}
    for e in trace:
        if e.get("cat") == "gpu_user_annotation" and e.get("name") in in_range:
            in_range[e["name"]] += e["dur"]
    for name, us in in_range.items():
        say(f"    range {name}: {us} us on the device timeline "
            f"({us / busy_us if busy_us else 0} of busy)")
    return dict(wall_us=wall_us, busy_us=busy_us, ranges=in_range, groups=groups,
                counts=counts, decode_overlaps=overlaps,
                top=[(name, n, us) for name, (n, us) in top])


def trace_engine_kw(dev):
    from repro_torch.core import VPE
    return dict(slots=SLOTS, max_len=MAX_LEN, block_size=BS, kv_layout="paged",
                prefill_chunk=CHUNK, decode_impl="cuda", prefill_kernel="cuda",
                device=dev, vpe=VPE())


def trace_decode_window(cfg, params, dev, trace_dir, horizon, steps, new_tokens,
                        label, experts=None):
    """A profiler window over ``steps`` steady decode calls of horizon
    ``horizon`` at 4 busy slots (graph replays, no prefill, no capture),
    on a new engine; raises unless the device launches of the paged
    decode kernels are 3 a step a layer.  ``experts``: see
    :func:`profiled`."""
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request
    eng = ContinuousBatchingEngine(cfg, params, decode_horizon=horizon,
                                   **trace_engine_kw(dev))
    for i, p in enumerate(traffic(cfg.vocab_size, seed=5)[:SLOTS]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    while eng.num_decoding < SLOTS:
        eng.step()
    st = eng.stats
    before = (st.decode_steps, eng.graphs.captures, st.horizon_calls)
    r = profiled(lambda: [eng.step() for _ in range(steps)], label, trace_dir,
                 experts=experts)
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
    return r


def phase_trace(cfg, params, dev, trace_dir):
    """Where the main path's time goes: a profiler window over 8 steady
    single decode steps at 4 busy slots, one over a steady fused horizon of
    16 steps, one over 4 steady speculative verify calls of span 4, and
    one over a 512-token prompt's four prefill chunks: the breakdown by
    kernel.  Its walls and idle shares hold the profiler's own
    cost (the unprofiled idle time is phase 4's steady window).  The device
    launches of the decode kernels must be 3 per step per layer, as in the
    profiled call of phases 4 and 4b."""
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request
    kw = trace_engine_kw(dev)
    prompts = traffic(cfg.vocab_size, seed=5)
    out = {}
    for horizon, steps, new_tokens in ((1, 8, NEW_TOKENS), (16, 1, 400)):
        label = f"decode_{steps}_steps" if horizon == 1 else "decode_horizon_16"
        out[label] = trace_decode_window(cfg, params, dev, trace_dir, horizon, steps,
                                         new_tokens, label)
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

# -- traced windows in a child process ---------------------------------------------------
#
# Late in a long process a torch.profiler session loses a prefix of its
# window's device records: the first 8-10 of 28,803 in five of six late
# decode windows (tools/trace_loss.py), records past layer 0's decode
# kernels (3 of 864 decode launches) in phase 6 of one --trace run, 5 of 20
# conv2d kernels in phase 10.  Idle margins of 0.25 s around the work do
# not change it: the records are lost inside the profiler, not at the
# window's edges.  So the traced windows whose launches are gated exactly
# run in a child process started for them, where nothing earlier has used
# the profiler; the child draws the model's weights from the seed the
# parent used, after the parent has freed its copy.

def in_child(fn_name, *args):
    """``fn_name(*args)``, a function of this module, run in a spawned
    child process: returns its (picklable) result, or raises with the
    child's traceback if it failed or exited without one."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=_child_main, args=(fn_name, args, results))
    proc.start()
    try:
        while True:
            try:
                status, out = results.get(timeout=5)
                break
            except queue.Empty:
                if not proc.is_alive():
                    raise AssertionError(f"{fn_name}: the child process exited with "
                                         f"code {proc.exitcode} and no result")
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
            proc.join()
    if status != "ok":
        raise AssertionError(f"{fn_name} failed in its child process:\n{out}")
    return out


def _child_main(fn_name, args, results):
    try:
        sys.path.insert(0, str(SRC))
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        results.put(("ok", globals()[fn_name](*args)))
    except Exception:       # the parent raises it, with this traceback
        import traceback
        results.put(("error", traceback.format_exc()))


def child_trace_main(dev, trace_dir):
    """Phase 6 on phase 4's model (qwen3-8b, seed 0), in a child process."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    cfg = get_config("qwen3-8b")
    params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(0))
    return phase_trace(cfg, params, dev, trace_dir)


def expert_gemm_kernels(cfg, params, dev, trace_dir):
    """The (kernel name, grid) pairs of a decode step's three expert
    products — a (1, E, C, d) buffer through layer 0's stacked expert
    weights, the einsums of ``moe._routed_experts`` — read from one
    profiled eager call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import moe_spec
    spec = moe_spec(cfg)
    w = {k: params["layers"][f"moe_experts_{k}"][0] for k in ("gate", "up", "down")}
    buf = torch.zeros((1, spec.padded_experts, capacity(spec, SLOTS), cfg.d_model),
                      dtype=w["gate"].dtype, device=dev)

    def products():
        g = torch.einsum("gecd,edf->gecf", buf, w["gate"])
        u = torch.einsum("gecd,edf->gecf", buf, w["up"])
        torch.einsum("gecf,efd->gecd", F.silu(g) * u, w["down"])

    products()
    prof, _ = profile_window(products)
    path = trace_dir / "trace_moe_expert_products.json.gz"
    trace_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with gzip.open(path, "rt") as f:
        return {(e["name"], tuple(e.get("args", {}).get("grid", ())))
                for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel" and kernel_group(e["name"]).endswith("GEMMs")}


def child_trace_moe(dev, trace_dir):
    """Phase 12's trace on its model (qwen2-moe-a2.7b, seed 0), in a child
    process: 8 steady decode steps, their paged decode launches gated at 3
    a layer a step, and the breakdown by kernel group, expert GEMMs apart."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    cfg = get_config(MOE_ARCH)
    params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(0))
    experts = expert_gemm_kernels(cfg, params, dev, trace_dir)
    say(f"  expert products' kernels (name, grid): {sorted(experts)}")
    trace = trace_decode_window(cfg, params, dev, trace_dir, 1, 8, NEW_TOKENS,
                                "moe_decode_8_steps", experts=experts)
    steps = trace["decode_steps"]
    trace["us_per_step"] = {g: us / steps for g, us in trace["groups"].items()}
    say(f"  moe_decode_8_steps by group, us a step: {trace['us_per_step']}; gaps "
        f"(wall - busy, profiled) {trace['profiled_idle_us_per_step']}; "
        f"{EXPERT_GROUP} events {trace['counts'].get(EXPERT_GROUP, 0)} (3 a layer a "
        f"step: {3 * cfg.num_layers * steps})")
    return trace


# -- the MoE path ------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    import torch
    return sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(tree))


def phase_moe(dev, trace_dir):
    """Phase 12: full-width qwen2-moe-a2.7b, all 24 layers in bf16 (random
    weights from a seeded generator on the card), on phase 4's engine and
    traffic: (a) H = 1 with phase 4's gates and steady window; (b) H = 16,
    tokens (a)'s request by request; (c) speculation at S = 4, the traffic
    twice, tokens (a)'s or parting at a near-tie; (d) first-step logits,
    cuda vs gather; with ``trace_dir`` a profiled window of 8 steady decode
    steps in a child process (:func:`child_trace_moe`); then (e) reduced
    MoE parity and (f) training."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.transformer import moe_spec
    cfg = get_config(MOE_ARCH)
    spec = moe_spec(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    expert_bytes = sum(tree_bytes(v) for k, v in params["layers"].items()
                       if k.startswith("moe_experts_"))
    say(f"[12] MoE path: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} routed experts "
        f"(padded to {spec.padded_experts}) top-{cfg.top_k} + {cfg.num_shared_experts} "
        f"shared, {cfg.moe_groups} routing groups, capacity factor "
        f"{cfg.capacity_factor}; {cfg.param_count()} params ({cfg.active_param_count()} "
        f"active a token) in {cfg.dtype}, router in float32; weights {weight_bytes} B "
        f"({expert_bytes} B of them expert weights, all read by each decode step), "
        f"initialised in {time.perf_counter() - t0} s")
    prompts = traffic(cfg.vocab_size)
    t_serve = time.perf_counter()
    say(f"[12a] {cfg.name}: phase 4's engine (paged, both kernels pinned, H = 1) and "
        f"traffic")
    main = phase_serving(cfg, params, dev, prompts, 1, "phase 12a", steady_calls=8)
    main_logits = main.pop("first_logits")
    say(f"[12b] {cfg.name}: decode_horizon=16, phase 12a's traffic")
    fused = phase_serving(cfg, params, dev, prompts, 16, "phase 12b", steady_calls=2)
    fused.pop("first_logits")
    first_difference("phase 12b", main, fused, "phase 12a")
    spec_run = phase_speculation(cfg, params, dev, prompts, main, main_logits,
                                 spans=(4,), tag="12c", ref_label="phase 12a")
    logits = phase_full_width_parity(cfg, params, dev, prompts[:SLOTS], atol=0.25,
                                     tag="12d")
    peak = torch.cuda.max_memory_allocated()
    serve_wall = time.perf_counter() - t_serve
    say(f"  phase 12a-d: weights {weight_bytes} B, peak memory {peak} B "
        f"({peak / 2 ** 30} GiB), wall {serve_wall} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    trace = None
    if trace_dir:
        say(f"[12t] trace of 8 steady decode steps of {cfg.name} (torch.profiler, in "
            f"a child process)")
        trace = in_child("child_trace_moe", dev, trace_dir)
    reduced = phase_moe_reduced_parity(dev)
    train = phase_moe_train(dev)
    return dict(weight_bytes=weight_bytes, expert_bytes=expert_bytes, peak_bytes=peak,
                serve=main, fused=fused, speculation=spec_run, logits=logits,
                trace=trace, reduced=reduced, train=train)


def phase_moe_reduced_parity(dev):
    """Phase 12e: reduced qwen2-moe-a2.7b and moonshot-v1-16b-a3b in f32 on
    the card, token for token: the kernels against the gather path, H = 4
    and 16 against 1, speculation at S = 4 against H = 1 (each prompt
    served twice), and paged against contiguous against ``auto`` (no VPE:
    every admission contiguous; then every admission forced paged).  With
    4 slots and prompts of at most 64 padded tokens every call routes at
    most 8 tokens a group, under the capacity floor of 8, so nothing drops
    and the layouts route alike: a decode step's 4 rows in one group, a
    verify call's 16 in 16, a 16-token chunk in 16, a whole prompt in 16
    groups of at most 4."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import pad_to_bucket
    from repro_torch.models import model as model_lib
    out = {}
    for name in MOE_PARITY_ARCHS:
        cfg = get_config(name).reduced()
        params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(1))
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                   for n in rng.integers(5, 60, 6)]
        if max(pad_to_bucket(len(p)) for p in prompts) > 8 * cfg.moe_groups:
            raise AssertionError("a whole prompt would route more than 8 tokens a group")
        kw = dict(slots=4, max_len=96, block_size=BS, prefill_chunk=16)
        runs = {"gather": run_engine(cfg, params, dev, ("grouped", "gather"), prompts,
                                     12, **kw)}
        kernels = run_engine(cfg, params, dev, ("cuda", "cuda"), prompts, 12, **kw)
        for H in (4, 16):
            runs[f"H={H}"] = run_engine(cfg, params, dev, ("cuda", "cuda"), prompts, 12,
                                        decode_horizon=H, **kw)
        for label, extra in (("contiguous", dict(kv_layout="contiguous")),
                             ("auto", dict(kv_layout="auto")),
                             ("auto, forced paged", dict(kv_layout="auto",
                                                         force_paged="all"))):
            runs[label] = run_engine(cfg, params, dev, ("cuda", "cuda"), prompts, 12,
                                     **{**kw, **extra})
        st = []
        twice = run_engine(cfg, params, dev, ("cuda", "cuda"), prompts + prompts, 12,
                           decode_horizon=4, spec_draft=4, stats=st, **kw)
        st = st[0]
        equal = {label: got == kernels for label, got in runs.items()}
        equal["spec_draft=4"] = twice == {i: kernels[i % len(prompts)]
                                          for i in range(2 * len(prompts))}
        say(f"[12e] reduced {cfg.name} ({cfg.dtype}, {cfg.num_experts} experts top-"
            f"{cfg.top_k}, {cfg.moe_groups} groups): tokens == (cuda, cuda) H=1 paged: "
            f"{equal}; spec: {st.spec_calls} verify calls, {st.accepted_tokens}/"
            f"{st.draft_tokens} drafts accepted")
        if not all(equal.values()) or not st.spec_calls or not st.accepted_tokens:
            raise AssertionError(f"reduced {cfg.name}: {equal}, {st.spec_calls} verify "
                                 f"calls, {st.accepted_tokens} accepted")
        out[name] = dict(equal=equal, spec_calls=st.spec_calls,
                         accepted=st.accepted_tokens, drafts=st.draft_tokens)
        del params
    return out


def phase_moe_train(dev):
    """Phase 12f: qwen2-moe-a2.7b at full width and 2 layers, 1 x 4096
    tokens (16 routing groups of 256 tokens, capacity 24: assignments may
    drop, as in the reference), ``TrainLoop`` with ``flash_cuda`` pinned
    for 3 steps; gates: finite losses and 2 flash launches a layer a step
    (remat)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.train_loop import STATIC_BUCKET, TrainLoop, TrainLoopConfig
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=0))
    loop = TrainLoop(cfg, TrainLoopConfig(total_steps=1000, warmup_steps=100,
                                          log_every=0), data, seed=0, device=dev)
    loop.vpe.controller.force("attn_impl", STATIC_BUCKET, "flash_cuda",
                              reason="chip_smoke counts the kernel's launches")
    torch.cuda.synchronize()
    state_bytes = tree_bytes((loop.params, loop.opt_state))
    say(f"[12f] MoE training: {cfg.name} at full width, {cfg.num_layers} layers, "
        f"{cfg.param_count()} params ({cfg.active_param_count()} active a token), "
        f"state {state_bytes} B, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"flash_cuda pinned, set up in {time.perf_counter() - t0} s")
    fa.reset_launch_counts()
    metrics = loop.run(MOE_TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    secs = [m["step_time_s"] for m in metrics]
    step_s = float(np.median(secs))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    expected = 2 * cfg.num_layers * MOE_TRAIN_STEPS
    say(f"  losses {losses}, step seconds {secs}; median {step_s} s, "
        f"{tokens / step_s} tokens/s; peak memory {peak} B ({peak / 2 ** 30} GiB); "
        f"flash launches {launches} (expected {expected}: 2 per layer per step "
        f"under remat)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"MoE training: non-finite loss: {losses}")
    if launches != expected:
        raise AssertionError(f"MoE training: flash launches {launches} != {expected}")
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, step_s=secs, tokens_per_s=tokens / step_s,
                peak_bytes=peak, state_bytes=state_bytes, launches=launches)


# -- the recurrent and encoder-decoder families (phase 13) --------------------------------

FAMILY_SLOTS, FAMILY_NEW, FAMILY_MAX_LEN = 4, 32, 1024
# two waves of 4 requests, 64..512 prompt tokens; each wave's longest prompt
# (256, 512) makes its left-padded span a multiple of 128, so both chunked
# scans' length checks (SSD chunk 128, WKV chunk 32) hold without padding
FAMILY_WAVES = ((64, 100, 180, 256), (120, 300, 400, 512))
# whisper-base: each wave's 4 prompts of one length (no left-pad) against
# 1500 frames
WHISPER_WAVES = (32, 256)
# limits on logits at the last prompt position: full-width bf16
# flash_cuda against reference, 0.25 (the bf16 tie scale of phases 5b and
# 12d, written down before the first chip run); prefill against a
# step-by-step decode replay in f32 weights, full width and reduced: the
# reference's test_prefill_matches_decode_replay limit.  In bf16 the replay
# is printed, not gated: random-weight zamba2 and rwkv6 amplify a one-step
# bf16 rounding difference ~200x over their layers (0.77 and 0.34 on the
# card, against 0.0089 and 0.00018 in f32)
FAMILY_LOGIT_ATOL, REPLAY_TOL = 0.25, 2e-2
# the flash kernel at this phase's shapes (Hq, Hkv, S, T, D, causal):
# zamba2-1.2b's shared block (prefill spans 256 and 512, training 4096);
# whisper-base's encoder (1500 frames), decoder self-attention (32, 256
# tokens) and cross-attention (32 and 256 rows against 1500 frames; and 32
# rows against 24 frames, the reduced config's negative row offset T - S)
FAMILY_FLASH_CASES = ((32, 32, 256, 256, 64, True), (32, 32, 512, 512, 64, True),
                      (32, 32, 4096, 4096, 64, True), (8, 8, 1500, 1500, 64, False),
                      (8, 8, 32, 32, 64, True), (8, 8, 256, 256, 64, True),
                      (8, 8, 32, 1500, 64, False), (8, 8, 256, 1500, 64, False),
                      (8, 8, 32, 24, 64, False))
# timed: zamba2-1.2b's training shape and whisper-base's encoder
FAMILY_FLASH_TIMES = ((32, 32, 4096, 4096, 64, True), (8, 8, 1500, 1500, 64, False))
FAMILY_TRAIN_STEPS, RWKV_TRAIN_LAYERS = 3, 2


def flash_per_prefill(cfg) -> int:
    """Flash launches of one prefill under ``flash_cuda``: one a shared-block
    application (hybrid); encoder self, decoder self and cross a layer
    (encdec); none (ssm)."""
    from repro_torch.models import hybrid
    if cfg.family == "hybrid":
        return hybrid.macro_counts(cfg)[0]
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.decoder_layers
    return 0


def family_waves(cfg, waves, seed=13):
    """Prompts a wave: seeded ids of the wave's lengths (``WHISPER_WAVES``
    gives one length a wave)."""
    rng = np.random.default_rng(seed)
    lens = [(n,) * FAMILY_SLOTS if isinstance(n, int) else n for n in waves]
    return [[rng.integers(0, cfg.vocab_size, m).astype(np.int32) for m in w]
            for w in lens]


def left_padded(wave):
    """A wave's (B, span) tokens as ``WaveScheduler`` builds them."""
    span = max(len(p) for p in wave)
    toks = np.zeros((len(wave), span), np.int32)
    for i, p in enumerate(wave):
        toks[i, -len(p):] = p
    return toks


def serve_waves(cfg, params, dev, waves, label, frames=None):
    """The waves on ``ServeLoop(batch=4)``: through ``WaveScheduler``, or for
    encdec one ``generate`` a wave with {"tokens", "frames"} (the
    scheduler hands ``generate`` tokens only, as the reference's does).
    The flash launch count is zeroed just before and read just after."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.serve_loop import Request, ServeLoop, WaveScheduler
    serve = ServeLoop(cfg, params, max_len=FAMILY_MAX_LEN, batch=FAMILY_SLOTS,
                      device=dev)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    if frames is None:
        sched = WaveScheduler(serve)
        for i, p in enumerate(p for wave in waves for p in wave):
            sched.submit(Request(rid=i, prompt=p, max_new_tokens=FAMILY_NEW))
        tokens = {r.rid: list(r.out) for r in sched.run()}
    else:
        tokens = {}
        for w, wave in enumerate(waves):
            out = serve.generate({"tokens": np.stack(wave), "frames": frames}, FAMILY_NEW)
            tokens.update({w * FAMILY_SLOTS + i: [int(t) for t in row]
                           for i, row in enumerate(out)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    st = serve.stats
    steps = len(waves) * FAMILY_NEW
    run = dict(tokens=tokens, prefill_s=st.prefill_s, decode_s=st.decode_s,
               decode_tok_per_s=st.decode_tok_per_s, step_ms=st.decode_s / steps * 1e3,
               flash_launches=launches, wall_s=wall)
    say(f"  {label}: {len(tokens)} requests in {len(waves)} waves of {FAMILY_SLOTS}, "
        f"{FAMILY_NEW} new tokens each; prefill {st.prefill_s} s, decode "
        f"{st.decode_tok_per_s} tok/s, decode wall a step {run['step_ms']} ms "
        f"({steps} steps), wall {wall} s; flash launches {launches}")
    bad = [t for out in tokens.values() for t in out if not 0 <= t < cfg.vocab_size]
    if bad or any(len(out) != FAMILY_NEW for out in tokens.values()):
        raise AssertionError(f"{label}: tokens out of range or missing: {bad[:8]}")
    expected = flash_per_prefill(cfg) * len(waves) if cfg.attn_impl == "flash_cuda" else 0
    if launches != expected:
        raise AssertionError(f"{label}: flash launches {launches} != {expected} "
                             f"({flash_per_prefill(cfg)} a prefill)")
    return run


def last_logits(cfg, params, dev, toks, frames=None):
    """(B, V) f32 logits at the last prompt position: one prefill."""
    import torch
    from repro_torch.models import model as model_lib
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    if frames is not None:
        batch["frames"] = frames
    cache = model_lib.init_cache(cfg, toks.shape[0], FAMILY_MAX_LEN, dev)
    return model_lib.prefill(cfg, params, batch, cache)[1][:, -1].float()


def replay_logits(cfg, params, dev, toks):
    """(B, V) f32 logits at the last prompt position: the prompt decoded one
    token at a time from an empty cache."""
    import torch
    from repro_torch.models import model as model_lib
    t = torch.as_tensor(toks, device=dev)
    cache = model_lib.init_cache(cfg, t.shape[0], FAMILY_MAX_LEN, dev)
    for i in range(t.shape[1]):
        cache, logits = model_lib.decode_step(cfg, params, cache, t[:, i:i + 1])
    return logits[:, -1].float()


def decode_step_breakdown(cfg, params, dev, toks, frames, label):
    """One eager lockstep decode step after a prefill of ``toks``: the
    device kernels it launches and their summed time (torch.profiler, one
    profiled step after 3 warm ones), and the mean wall of 5 unprofiled
    steps; the card's idle share is 1 - busy / wall."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.models import model as model_lib
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    if frames is not None:
        batch["frames"] = frames
    cache = model_lib.init_cache(cfg, toks.shape[0], FAMILY_MAX_LEN, dev)
    cache, logits = model_lib.prefill(cfg, params, batch, cache)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    for _ in range(3):
        cache, _ = model_lib.decode_step(cfg, params, cache, tok)
    holder = {}

    def one():
        holder["cache"] = model_lib.decode_step(cfg, params, cache, tok)[0]

    prof, wall_us = profile_window(one)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    cache = holder.pop("cache")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        cache, _ = model_lib.decode_step(cfg, params, cache, tok)
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) / 5 * 1e6
    say(f"  {label}: a decode step launches {len(kernels)} kernels, device busy "
        f"{busy_us} us (profiled wall {wall_us} us); unprofiled {step_us} us a step, "
        f"idle share {1 - busy_us / step_us}")
    return dict(kernels=len(kernels), busy_us=busy_us, profiled_wall_us=wall_us,
                step_us=step_us, idle_share=1 - busy_us / step_us)


def logit_gate(label, got, want, atol):
    """Max abs difference of two (B, V) logit blocks within ``atol``; both
    finite; the argmax agreement printed."""
    import torch
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{label}: non-finite logits")
    diff = float((got - want).abs().max())
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    say(f"  {label}: max |diff| {diff} (limit {atol}), argmax equal in {agree} of "
        f"{got.shape[0]}")
    if diff > atol:
        raise AssertionError(f"{label}: logits differ by {diff} > {atol}")
    return dict(max_abs_diff=diff, argmax_equal=agree)


def phase_family_serving(dev, name, tag):
    """Phase 13a-c: ``name`` at full width in bf16 (random weights from a
    seeded generator on the card), two waves of 4 on ``ServeLoop`` with
    ``flash_cuda`` pinned where the family has attention; gates: tokens in
    range, the flash launches a prefill, first-step logits ``flash_cuda``
    against ``reference`` within ``FAMILY_LOGIT_ATOL``; for the recurrent
    families prefill against a step-by-step decode replay of wave 1,
    printed in bf16, then gated within ``REPLAY_TOL`` on the same weights
    in f32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    cfg = get_config(name)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    params = model_lib.init_params(cfg, gen)
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    cache_bytes = tree_bytes(model_lib.init_cache(cfg, FAMILY_SLOTS, FAMILY_MAX_LEN, dev))
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((FAMILY_SLOTS, cfg.source_len, cfg.d_model), generator=gen,
                             device=dev).to(getattr(torch, cfg.dtype))
    waves = family_waves(cfg, WHISPER_WAVES if frames is not None else FAMILY_WAVES)
    run_cfg = (cfg if cfg.attention_free
               else dataclasses.replace(cfg, attn_impl="flash_cuda"))
    say(f"[{tag}] {cfg.name} ({cfg.family}) at full width: {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.param_count()} params in {cfg.dtype}; weights "
        f"{weight_bytes} B, lockstep cache {cache_bytes} B at batch {FAMILY_SLOTS} x "
        f"max_len {FAMILY_MAX_LEN}; attn_impl {run_cfg.attn_impl}"
        + (" (no attention: no kernel runs in this phase)" if cfg.attention_free else
           f" ({flash_per_prefill(cfg)} flash launches a prefill)")
        + f"; prompt lengths {[[len(p) for p in w] for w in waves]}; initialised in "
        f"{time.perf_counter() - t0} s")
    run = serve_waves(run_cfg, params, dev, waves, f"phase {tag}", frames)
    toks = np.stack(waves[0]) if frames is not None else left_padded(waves[0])
    run["decode_step"] = decode_step_breakdown(run_cfg, params, dev, toks, frames,
                                               f"phase {tag}")
    first = last_logits(run_cfg, params, dev, toks, frames)
    if not cfg.attention_free:
        run["flash_vs_reference"] = logit_gate(
            f"phase {tag} first-step logits, flash_cuda vs reference", first,
            last_logits(cfg, params, dev, toks, frames), FAMILY_LOGIT_ATOL)
    if cfg.family != "encdec":
        t1 = time.perf_counter()
        replay = replay_logits(run_cfg, params, dev, toks)
        run["replay_step_ms"] = (time.perf_counter() - t1) / toks.shape[1] * 1e3
        run["prefill_vs_replay_bf16"] = float((first - replay).abs().max())
        say(f"  phase {tag} wave 1 ({toks.shape[1]} tokens), bf16: prefill vs decode "
            f"replay max |diff| {run['prefill_vs_replay_bf16']} (not gated), argmax "
            f"equal in {int((first.argmax(-1) == replay.argmax(-1)).sum())} of "
            f"{toks.shape[0]}; replay {run['replay_step_ms']} ms a step")
    peak = torch.cuda.max_memory_allocated()
    say(f"  phase {tag}: weights {weight_bytes} B, cache {cache_bytes} B, peak memory "
        f"{peak} B ({peak / 2 ** 30} GiB)")
    run.update(weight_bytes=weight_bytes, cache_bytes=cache_bytes, peak_bytes=peak)
    del params, frames
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.family != "encdec":
        f32 = dataclasses.replace(run_cfg, dtype="float32")
        params = model_lib.init_params(f32, torch.Generator(dev).manual_seed(0))
        run["prefill_vs_replay_f32"] = logit_gate(
            f"phase {tag} wave 1, the same weights in f32: prefill vs decode replay",
            last_logits(f32, params, dev, toks), replay_logits(f32, params, dev, toks),
            REPLAY_TOL)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return run


def phase_family_flash(dev):
    """Phase 13d: the flash kernel at this phase's shapes against its plain
    version, bf16 and f32 with phase 3's tolerances; then, at zamba2's
    training shape and whisper's encoder, its time beside the plain
    version's, one SDPA call's (timed only) and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    say("[13d] flash kernel at the recurrent and encoder-decoder shapes (B=1, head_dim "
        "64) against its plain version")
    gen = torch.Generator(dev).manual_seed(13)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for Hq, Hkv, S, T, D, causal in FAMILY_FLASH_CASES:
            q, k, v = flash_inputs(gen, dtype, Hq, Hkv, S, T, D)
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = ref.attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = max(err, check_close(
                f"flash {str(dtype)[6:]} Hq={Hq} Hkv={Hkv} D={D} S={S} T={T} "
                f"causal={causal} (row offset {T - S})", got, want,
                *flash_tolerance(dtype)))
            del q, k, v, got, want
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    times = {}
    for Hq, Hkv, S, T, D, causal in FAMILY_FLASH_TIMES:
        q, k, v = flash_inputs(gen, torch.bfloat16, Hq, Hkv, S, T, D)
        kernel = lambda: fa.flash_attention_cuda(q, k, v, causal=causal)  # noqa: E731
        plain = lambda: ref.attention_ref(q, k, v, causal=causal)  # noqa: E731
        shape = f"B=1 Hq={Hq} Hkv={Hkv} S={S} T={T} D={D} causal={causal} bf16"
        e = check_close(f"flash_attention [{shape}]", kernel(), plain(),
                        *flash_tolerance(torch.bfloat16))
        ms, plain_ms = device_ms(kernel, flush), device_ms(plain, flush)
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), flush)
        nbytes, ops = flash_work(S, T, Hq, Hkv, D, causal, None, 2)
        bound_ms, bound_by = bound(nbytes, ops, "bfloat16")
        say(f"  flash_attention [{shape}]: kernel {ms} ms, plain {plain_ms} ms, SDPA "
            f"{library_ms} ms, bound {bound_ms} ms ({bound_by}: {nbytes} B, {ops} ops), "
            f"kernel/bound {ms / bound_ms}")
        times[shape] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms, bytes=nbytes,
                            ops=ops)
        del q, k, v
    del flush
    return dict(max_abs_err=err, times=times)


def phase_family_reduced_parity(dev):
    """Phase 13e: the reduced configs in f32 on the card (zamba2-1.2b also
    at 5 layers, with a mamba tail): two waves through ``ServeLoop``, greedy
    tokens equal between ``flash_cuda`` and ``reference`` (rwkv6-7b, which
    has no attention: ``wkv_impl`` chunked and sequential), and prefill
    against a decode replay within ``REPLAY_TOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    out = {}
    for name, layers in (("zamba2-1.2b", None), ("zamba2-1.2b", 5), ("rwkv6-7b", None),
                         ("whisper-base", None)):
        cfg = get_config(name).reduced()
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        gen = torch.Generator(dev).manual_seed(2)
        params = model_lib.init_params(cfg, gen)
        frames = None
        if cfg.family == "encdec":
            frames = torch.randn((FAMILY_SLOTS, cfg.source_len, cfg.d_model),
                                 generator=gen, device=dev)
            waves = family_waves(cfg, (32, 16), seed=2)
        else:
            waves = family_waves(cfg, ((16, 9, 32, 20), (5, 12, 16, 7)), seed=2)
        axis, variants = (("wkv_impl", ("chunked", "sequential")) if cfg.attention_free
                          else ("attn_impl", ("flash_cuda", "reference")))
        label = f"reduced {cfg.name} at {cfg.num_layers} layers"
        runs = {v: serve_waves(dataclasses.replace(cfg, **{axis: v}), params, dev, waves,
                               f"phase 13e {label}, {axis}={v}", frames)
                for v in variants}
        equal = runs[variants[0]]["tokens"] == runs[variants[1]]["tokens"]
        say(f"  phase 13e {label}: tokens {axis} {variants[0]} == {variants[1]}: {equal}")
        if not equal:
            raise AssertionError(f"phase 13e {label}: tokens differ across {axis}")
        out[f"{name}/{cfg.num_layers}"] = dict(equal=equal)
        if cfg.family != "encdec":
            toks = left_padded(waves[0])
            out[f"{name}/{cfg.num_layers}"]["prefill_vs_replay"] = logit_gate(
                f"phase 13e {label}: prefill vs decode replay",
                last_logits(cfg, params, dev, toks),
                replay_logits(cfg, params, dev, toks), REPLAY_TOL)
        del params, frames
    return out


def phase_family_train(dev):
    """Phase 13f: zamba2-1.2b at full width and rwkv6-7b at full width cut to
    2 layers (its 7.5 B parameters with f32 master, m and v would need ~120
    GB), ``TrainLoop`` at 1 x 4096 tokens, remat, the scan variant
    ``chunked`` and ``flash_cuda`` pinned, 3 steps: finite losses and flash
    launches of 2 a shared-block application a step (forward and remat
    recompute; the backward runs the reference's VJP) — 12 for zamba2, none
    for rwkv6.  Then whisper-base: one ``loss_fn`` backward at full width
    with frames, 4 x 256 tokens: finite gradients and 2 flash launches an
    attention (36)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.train_loop import STATIC_BUCKET, TrainLoop, TrainLoopConfig
    out = {}
    for name, layers, pinned in (
            ("zamba2-1.2b", None, {"ssd_impl": "chunked", "attn_impl": "flash_cuda"}),
            ("rwkv6-7b", RWKV_TRAIN_LAYERS, {"wkv_impl": "chunked"})):
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH, seed=0))
        loop = TrainLoop(cfg, TrainLoopConfig(total_steps=1000, warmup_steps=100,
                                              log_every=0), data, seed=0, device=dev)
        for axis, variant in pinned.items():
            loop.vpe.controller.force(axis, STATIC_BUCKET, variant,
                                      reason="chip_smoke pins the variants")
        torch.cuda.synchronize()
        state_bytes = tree_bytes((loop.params, loop.opt_state))
        say(f"[13f] training {cfg.name} at full width, {cfg.num_layers} layers, "
            f"{cfg.param_count()} params, state {state_bytes} B, batch {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} tokens, remat {cfg.remat}, pinned {pinned}, set up in "
            f"{time.perf_counter() - t0} s")
        fa.reset_launch_counts()
        metrics = loop.run(FAMILY_TRAIN_STEPS)
        torch.cuda.synchronize()
        launches = fa.flash_attention_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        losses = [m["loss"] for m in metrics]
        secs = [m["step_time_s"] for m in metrics]
        expected = 2 * flash_per_prefill(cfg) * FAMILY_TRAIN_STEPS
        say(f"  losses {losses}, step seconds {secs}, {TRAIN_BATCH * TRAIN_SEQ / np.median(secs)} "
            f"tokens/s; peak memory {peak} B ({peak / 2 ** 30} GiB); flash launches "
            f"{launches} (expected {expected})")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"training {cfg.name}: non-finite loss: {losses}")
        if launches != expected:
            raise AssertionError(f"training {cfg.name}: flash launches {launches} != "
                                 f"{expected}")
        out[name] = dict(losses=losses, step_s=secs, peak_bytes=peak,
                         state_bytes=state_bytes, launches=launches)
        del loop
    cfg = dataclasses.replace(get_config("whisper-base"), attn_impl="flash_cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(dev).manual_seed(3)
    params = model_lib.init_params(cfg, gen)
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    leaves = [p.requires_grad_() for p in leaves]
    toks = torch.randint(0, cfg.vocab_size, (FAMILY_SLOTS, 257), generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": torch.randn((FAMILY_SLOTS, cfg.source_len, cfg.d_model),
                                   generator=gen, device=dev).to(getattr(torch, cfg.dtype))}
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    loss = model_lib.loss_fn(cfg, torch.utils._pytree.tree_unflatten(leaves, spec), batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    expected = 2 * flash_per_prefill(cfg)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    peak = torch.cuda.max_memory_allocated()
    say(f"[13f] whisper-base loss_fn backward at full width, {FAMILY_SLOTS} x 256 tokens "
        f"against {cfg.source_len} frames: loss {float(loss.detach())}, gradients finite "
        f"{finite}, {wall} s, peak memory {peak} B; flash launches {launches} "
        f"(expected {expected})")
    if not (finite and np.isfinite(float(loss.detach()))):
        raise AssertionError("whisper-base: non-finite loss or gradients")
    if launches != expected:
        raise AssertionError(f"whisper-base backward: flash launches {launches} != "
                             f"{expected}")
    out["whisper-base"] = dict(loss=float(loss.detach()), wall_s=wall, peak_bytes=peak,
                               launches=launches)
    del params, leaves, grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_families(dev):
    """Phase 13: the recurrent and encoder-decoder families."""
    t0 = time.perf_counter()
    out = {"zamba2-1.2b": phase_family_serving(dev, "zamba2-1.2b", "13a"),
           "rwkv6-7b": phase_family_serving(dev, "rwkv6-7b", "13b"),
           "whisper-base": phase_family_serving(dev, "whisper-base", "13c"),
           "flash": phase_family_flash(dev),
           "reduced": phase_family_reduced_parity(dev),
           "train": phase_family_train(dev)}
    out["wall_s"] = time.perf_counter() - t0
    say(f"  phase 13 wall {out['wall_s']} s")
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
    say("[3c] flash kernel against its plain version (B=1); the bf16 backward "
        "kernel against the f32 VJP of attention_chunked")
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


def phase_flash_bwd_checks(dev) -> float:
    """Phase 3c's backward half: :func:`check_flash_bwd` at
    :data:`FLASH_BWD_CASES`; returns the largest absolute error."""
    import torch
    gen = torch.Generator(dev).manual_seed(16)
    return max(check_flash_bwd(gen, *heads, S, T, causal, window)
               for heads, (S, T, causal, window) in FLASH_BWD_CASES)


def check_flash_bwd(gen, Hq, Hkv, D, S, T, causal, window) -> float:
    """The bf16 gradients of ``attention_flash`` (the forward kernel with its
    log-sum-exp, then the backward kernel) against autograd through
    ``attention_chunked`` in f32 (TF32 off) at the same bf16 inputs; held
    by :data:`FLASH_BWD_REL` on each gradient's norm.  Returns the largest
    absolute error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import layers
    q, k, v = (t.requires_grad_() for t in
               flash_inputs(gen, torch.bfloat16, Hq, Hkv, S, T, D))
    g = torch.randn(q.shape, generator=gen, device=q.device).bfloat16()
    before = fa.flash_attention_bwd_cuda.launches
    o = layers.attention_flash(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(o, (q, k, v), g)
    with ref.full_f32():
        q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
        o32 = layers.attention_chunked(q32, k32, v32, causal=causal, window=window)
        want = torch.autograd.grad(o32, (q32, k32, v32), g.float())
    torch.cuda.synchronize()
    if fa.flash_attention_bwd_cuda.launches != before + 1:
        raise AssertionError("attention_flash's bf16 backward did not launch the kernel")
    worst = 0.0
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"flash backward {what}: non-finite gradient")
        rel = float((a.float() - b).norm() / b.norm())
        err = float((a.float() - b).abs().max())
        say(f"  attention_flash bf16 {what} vs attention_chunked f32 VJP (Hq={Hq} "
            f"Hkv={Hkv} D={D} S={S} T={T} causal={causal} window={window}): relative "
            f"distance {rel} (limit {FLASH_BWD_REL}), max_abs_err {err}")
        if rel > FLASH_BWD_REL:
            raise AssertionError(f"flash backward {what}: relative distance {rel} "
                                 f"exceeds {FLASH_BWD_REL}")
        worst = max(worst, err)
    return worst


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


def phase_flash_bwd_time(dev, cfg):
    """The flash backward kernel at the training path's shapes (bf16, from
    the forward kernel's output and log-sum-exp): checked against its plain
    version (``ref.flash_attention_bwd_ref``); kernel, the f32 VJP of
    ``attention_chunked`` (the plain backward it replaced) and SDPA's
    backward (timed only) timed with L2 flushed; the bound is twice the
    forward's operations and bytes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import layers
    S = T = TRAIN_SEQ
    Hq, Hkv, D, window = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.window
    if window is not None and window < S:
        raise AssertionError("the SDPA yardstick assumes the window spans the sequence")
    gen = torch.Generator(dev).manual_seed(8)
    q, k, v = flash_inputs(gen, torch.bfloat16, Hq, Hkv, S, T, D)
    g = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    out, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=window, with_lse=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    kernel = lambda: fa.flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, out, lse, g, causal=True, window=window)
    shape = f"B=1 Hq={Hq} Hkv={Hkv} S=T={S} D={D} causal window={window} bf16"
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal=True, window=window,
                                       block_q=256, block_k=256)
    err = max(check_close(f"flash_attention_bwd {what} [{shape}]", a, b, *FLASH_BWD_TOL)
              for what, a, b in zip(("dq", "dk", "dv"), kernel(), want))
    del want
    ms = device_ms(kernel, flush)
    tq, tk, tv = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def plain():
        with ref.full_f32():
            o = layers.attention_chunked(tq, tk, tv, causal=True, window=window)
            return torch.autograd.grad(o, (tq, tk, tv), g)

    plain_ms = device_ms(plain, flush, iters=5)
    so = F.scaled_dot_product_attention(tq, tk, tv, is_causal=True, enable_gqa=True)
    library_ms = device_ms(lambda: torch.autograd.grad(so, (tq, tk, tv), g,
                                                       retain_graph=True), flush)
    nbytes, ops = flash_work(S, T, Hq, Hkv, D, True, window, 2)
    bound_ms, bound_by = bound(2 * nbytes, 2 * ops, "bfloat16")
    say(f"  flash_attention_bwd [{shape}]: kernel {ms} ms, plain {plain_ms} ms, "
        f"SDPA backward {library_ms} ms, bound {bound_ms} ms ({bound_by}: {2 * nbytes} B, "
        f"{2 * ops} ops), kernel/bound {ms / bound_ms}, max_abs_err vs plain {err}")
    del flush, so
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, bytes=2 * nbytes, ops=2 * ops,
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
    bwd_launches = fa.flash_attention_bwd_cuda.launches
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
        f"(expected {expected}: 2 per layer per step under remat), backward "
        f"launches {bwd_launches} (expected {expected // 2}: 1 per layer per step)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if launches != expected:
        raise AssertionError(f"flash launches {launches} != {expected}")
    if bwd_launches != expected // 2:
        raise AssertionError(f"flash backward launches {bwd_launches} != {expected // 2}")

    traces = None
    if trace_dir:
        batch = data.batch_at(loop.step)
        say("[7b] trace of one training step (torch.profiler)")
        traces = profiled(lambda: loop.run_step(batch), "train_step", trace_dir,
                          ranges=("train_step.loss_and_grads", "train_step.optimizer",
                                  "attention_flash.backward",
                                  "attention_flash.backward.plain"))

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
               restore_s=restore_s, trace=traces, bwd_launches=bwd_launches)
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


# phase 16: training on the (data, model) mesh.  Full-width h2o-danube-3-4b
# cut to MESH_LAYERS layers, so that four ranks' training state fits the
# card together (1 since phase 18 joined the script: 4 until then, and
# the script must end within its time; gloo's host copies of the
# gradients, which scale with the depth, are most of the phase's time);
# every rank a process of its own on cuda:0 over gloo,
# flash_cuda pinned.  (a) f32, gated against the (1, 1) run in the parent;
# (b) bf16, timed; (c) compressed_psum at 4 ranks, CUDA against CPU; (d)
# (a) and (b) with fsdp (params and optimizer state cut over data too).
MESH_LAYERS = 1
MESH_SHAPES = ((2, 1), (1, 2), (2, 2))
FSDP_SHAPES = ((2, 1), (2, 2))
MESH_SEED = 16
MESH_F32 = (2, 1024, 3)            # global batch, sequence, steps
MESH_BF16 = (2, 4096, 1, 2)        # global batch, sequence, warm-up, timed steps
# (a)'s limits against (1, 1), set before the first run: f32 sums in another
# order and over other ranks, through 3 AdamW steps
MESH_LOSS_REL = MESH_GNORM_REL = 1e-4
# (b)'s bf16 losses against (1, 1)'s: every rank's partial sums in f32, the
# roundings to bf16 at other points.  Set from the recorded readings
# (PERF.md): at most 6.5e-5 relative over the meshes in two runs
MESH_BF16_LOSS_REL = 5e-4
MESH_PSUM = (4096, 3840)           # (c): one rank's tensor
# a rank's peak while its loop is built: at least the state the dry run
# reckons (less AdamW's step, which lives on the host), at most this more
# (the draw's transients, the allocator's rounding)
MESH_BUILD_SLACK = 0.3e9


def mesh_cfg(dtype: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TRAIN_ARCH), num_layers=MESH_LAYERS,
                               dtype=dtype, attn_impl="flash_cuda")


def mesh_build(cfg, shape, fsdp: bool):
    """The dry run's build of one rank of ``shape``'s bf16 2 x 4096 step
    (``launch.specs.build_train`` on the meta device: nothing allocated)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import specs
    return specs.build_train(cfg, ShapeConfig("mesh", "train", MESH_BF16[1], MESH_BF16[0]),
                             specs.dry_mesh(*shape), fsdp=fsdp, tp=True)


def mesh_state_bytes(cfg, shape, grads: bool = True, fsdp: bool = False) -> int:
    """The training state one rank of ``shape`` holds, the dry run's
    reckoning: params, m, v, the f32 master of low-precision params and
    AdamW's step, and with ``grads`` the gradients (the params' bytes)."""
    from repro_torch.launch import specs
    built = mesh_build(cfg, shape, fsdp)
    return specs.tree_bytes(built.state) + (specs.tree_bytes(built.args[0]) if grads else 0)


def timed_group(group):
    """``group`` (a rank's ShardGroup) with the host wall of its fsdp
    collectives summed in ``.seconds`` by kind (each ends when gloo has
    moved the data: the call blocks)."""
    import torch
    from repro_torch.distributed.group import ShardGroup

    class Timed(ShardGroup):
        def _timed(self, kind, fn, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            self.seconds[kind] += time.perf_counter() - t
            return out

        def all_gather_(self, parts, x, group=None):
            return self._timed("all-gather", super().all_gather_, parts, x, group)

        def reduce_scatter_(self, out, parts, group=None):
            return self._timed("reduce-scatter", super().reduce_scatter_, out, parts, group)
    timed = Timed(group.rank, group.world, group.backend)
    timed.seconds = {"all-gather": 0.0, "reduce-scatter": 0.0}
    return timed


def mesh_loop(cfg, shape, group, batch, seq, steps, fsdp=False):
    import torch
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.distributed.group import MeshGroups
    from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
    lc = TrainLoopConfig(total_steps=steps, warmup_steps=1, log_every=0,
                         enable_vpe=False, watchdog=False)
    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch, seed=MESH_SEED))
    mesh = MeshGroups(group, *shape) if group is not None else None
    return TrainLoop(cfg, lc, data, seed=MESH_SEED, device=torch.device("cuda", 0),
                     mesh=mesh, fsdp=fsdp)


def fenced_us(fn, iters=3) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e6


def mesh_run(group, shape, fsdp=False):
    """Phase 16 (a) and (b) on one rank of ``shape`` (or, with ``group``
    None, at (1, 1) in the parent), with ``fsdp`` phase 16d's; (c) on the
    ranks of (2, 2) without fsdp."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = group.rank if group is not None else 0
    out = {"rank": rank, "shape": shape, "fsdp": fsdp}
    if group is not None:
        group = timed_group(group)

    # (a) f32: the gated run
    cfg = mesh_cfg("float32")
    batch, seq, steps = MESH_F32
    loop = mesh_loop(cfg, shape, group, batch, seq, steps, fsdp)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    metrics = loop.run(steps)
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    sums = bit_sums(loop.params)
    out["a"] = dict(
        losses=[m["loss"] for m in metrics], gnorms=[m["grad_norm"] for m in metrics],
        launches=launches, sums=sums,
        split=[k for k in sums if shape[1] > 1 and sharding.splits_leaf(cfg, shape[1], k)],
        heads=(loop.local_cfg.num_heads, loop.local_cfg.num_kv_heads),
        d_ff=loop.local_cfg.d_ff, d=rank // shape[1], m=rank % shape[1])
    del loop, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # (b) bf16: the timed run; peaks above what was allocated before
    cfg = mesh_cfg("bfloat16")
    batch, seq, warm, steps = MESH_BF16
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loop = mesh_loop(cfg, shape, group, batch, seq, warm + steps, fsdp)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() - base
    loop.run(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if group is not None:
        group.seconds.update({k: 0.0 for k in group.seconds})
    metrics = loop.run(warm + steps)[-steps:]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    step_s = [m["step_time_s"] for m in metrics]
    b = dict(losses=[m["loss"] for m in metrics], step_s=step_s,
             tokens_per_s=batch * seq / float(np.median(step_s)), peak_bytes=peak,
             init_peak_bytes=init_peak,
             init_reckoned_bytes=mesh_state_bytes(cfg, shape, grads=False, fsdp=fsdp),
             state_bytes=tree_bytes((loop.params, loop.opt_state)),
             reckoned_bytes=mesh_state_bytes(cfg, shape, fsdp=fsdp))
    if group is not None:
        b["fsdp_us_a_step"] = {k: v / steps * 1e6 for k, v in group.seconds.items()}
    if loop.mesh is not None:
        leaves = torch.utils._pytree.tree_leaves(loop.params)
        grads = [torch.zeros_like(p) for p in leaves]
        b["grad_bytes"] = tree_bytes(grads)
        b["grad_all_reduce_us"] = fenced_us(lambda: loop.mesh.sync(grads))
        del grads
        if shape[1] > 1:
            x = torch.ones((batch, seq, cfg.d_model), device="cuda")
            b["act_bytes"] = x.numel() * 4
            b["act_all_reduce_us"] = fenced_us(
                lambda: dist.all_reduce(x, group=loop.mesh.groups.model))
            del x
    out["b"] = b
    del loop, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # (c) compressed_psum over the 4 ranks, a CUDA tensor against its copy
    # on the CPU
    if shape == (2, 2) and not fsdp:
        from repro_torch.optim.compression import compressed_psum, quantize
        gen = torch.Generator("cuda").manual_seed(MESH_SEED + rank)
        x = torch.randn(MESH_PSUM, generator=gen, device="cuda") * (rank + 1)
        y = compressed_psum(x)
        torch.cuda.synchronize()
        y_cpu = compressed_psum(x.cpu())
        scale = quantize(x.cpu())[1].max().reshape(1)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX)
        out["c"] = dict(max_abs_err=float((y.cpu() - y_cpu).abs().max()),
                        step=float(scale), us=fenced_us(lambda: compressed_psum(x)),
                        us_cpu=fenced_us(lambda: compressed_psum(x.cpu())))
    return out


def mesh_runs(group, shape, fsdps):
    """:func:`mesh_run` of this rank of ``shape`` once for each of ``fsdps``,
    in turn (one spawn pays the ranks' start once)."""
    return [mesh_run(group, shape, fsdp) for fsdp in fsdps]


def gate_mesh_runs(runs, ref, ref_b, tag_a, tag_b, worst, launches):
    """Phase 16a/b (or 16d) gates of each rank of ``runs`` against (1, 1)'s
    f32 run ``ref`` and bf16 losses ``ref_b``; prints each rank's lines."""
    expected = 2 * MESH_LAYERS * MESH_F32[2]
    for shape, res in runs.items():
        for r in res:
            a, b = r["a"], r["b"]
            rl = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], ref["losses"]))
            rg = max(abs(x - y) / abs(y) for x, y in zip(a["gnorms"], ref["gnorms"]))
            rb = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], ref_b))
            worst["loss"], worst["grad_norm"] = max(worst["loss"], rl), max(worst["grad_norm"], rg)
            worst["bf16_loss"] = max(worst["bf16_loss"], rb)
            launches[f"{tag_a} {shape[0]}x{shape[1]} rank {r['rank']}"] = a["launches"]
            say(f"  [{tag_a}] {shape} rank {r['rank']} (d, m) = ({a['d']}, {a['m']}): heads "
                f"{a['heads']}, d_ff {a['d_ff']}; f32 losses {a['losses']}, grad norms "
                f"{a['gnorms']} (worst relative against (1, 1): loss {rl}, grad norm "
                f"{rg}); flash launches {a['launches']} (expected {expected})")
            say(f"  [{tag_b}] {shape} rank {r['rank']}: bf16 {MESH_BF16[0]} x {MESH_BF16[1]} "
                f"tokens, step seconds {b['step_s']} (the slowest rank's), "
                f"{b['tokens_per_s']} tokens/s of the mesh, peak memory "
                f"{b['peak_bytes']} B, state {b['state_bytes']} B (reckoned with the "
                f"gradients {b['reckoned_bytes']} B), gradient all-reduce "
                f"{b.get('grad_all_reduce_us')} us for {b.get('grad_bytes')} B of "
                f"gradients, activation all-reduce {b.get('act_all_reduce_us')} us "
                f"for {b.get('act_bytes')} B, fsdp collectives a step "
                f"{b.get('fsdp_us_a_step')} us; losses {b['losses']} (worst relative "
                f"against (1, 1): {rb}); peak while the loop is built "
                f"{b['init_peak_bytes']} B (reckoned state without the gradients "
                f"{b['init_reckoned_bytes']} B)")
            if rl > MESH_LOSS_REL or rg > MESH_GNORM_REL:
                raise AssertionError(f"phase {tag_a}: mesh {shape} rank {r['rank']}: losses "
                                     f"{a['losses']} / grad norms {a['gnorms']} against "
                                     f"{ref['losses']} / {ref['gnorms']}")
            if a["launches"] != expected:
                raise AssertionError(f"phase {tag_a}: mesh {shape} rank {r['rank']}: flash "
                                     f"launches {a['launches']} != {expected}")
            if not all(np.isfinite(b["losses"])) or rb > MESH_BF16_LOSS_REL:
                raise AssertionError(f"phase {tag_b}: mesh {shape} rank {r['rank']}: bf16 "
                                     f"losses {b['losses']} against (1, 1)'s {ref_b} "
                                     f"(limit {MESH_BF16_LOSS_REL} relative)")
        if res[0]["fsdp"]:
            continue            # data ranks hold different slices
        # a leaf no rank splits is the same bits on every rank; every leaf on
        # every data rank of one model index
        r0 = res[0]["a"]
        for key, n in r0["sums"].items():
            holders = [r for r in res if key not in r0["split"] or r["a"]["m"] == 0]
            if any(r["a"]["sums"][key] != n for r in holders):
                raise AssertionError(f"phase {tag_a}: mesh {shape}: leaf {key} differs "
                                     f"across the ranks that hold it whole")
        for r in res:
            twin = res[r["a"]["m"]]["a"]["sums"]
            if r["a"]["sums"] != twin:
                raise AssertionError(f"phase {tag_a}: mesh {shape}: rank {r['rank']}'s "
                                     f"leaves differ from data rank 0's")


def phase_train_mesh(dev):
    """Phase 16: training on the (data, model) mesh (see the constants)."""
    import torch
    from repro_torch.distributed.group import spawn_ranks
    cfg = mesh_cfg("float32")
    say(f"[16] training on the (data, model) mesh: {TRAIN_ARCH} at full width, "
        f"{MESH_LAYERS} layers ({cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), flash_cuda pinned, "
        f"meshes (1, 1) in this process and {MESH_SHAPES} as rank processes on "
        f"cuda:0 over gloo, then {FSDP_SHAPES} with fsdp (16d); the dry run's "
        f"reckoned state a rank (params, m, v, master, grads): "
        + ", ".join(f"{s}{' fsdp' if f else ''}: f32 {mesh_state_bytes(cfg, s, fsdp=f)} B, "
                    f"bf16 {mesh_state_bytes(mesh_cfg('bfloat16'), s, fsdp=f)} B"
                    for s, f in [((1, 1), False), *((s, False) for s in MESH_SHAPES),
                                 *((s, True) for s in FSDP_SHAPES)]))
    gc.collect()
    torch.cuda.empty_cache()
    runs = {(1, 1): [mesh_run(None, (1, 1))]}
    fsdp_runs = {}
    # one spawn a shape runs its replicated and its fsdp runs in turn
    for shape in dict.fromkeys(MESH_SHAPES + FSDP_SHAPES):
        fsdps = [f for f, shapes in ((False, MESH_SHAPES), (True, FSDP_SHAPES))
                 if shape in shapes]
        t0 = time.perf_counter()
        res = spawn_ranks(mesh_runs, ["cuda:0"] * (shape[0] * shape[1]), (shape, fsdps))
        for i, fsdp in enumerate(fsdps):
            (fsdp_runs if fsdp else runs)[shape] = [r[i] for r in res]
        say(f"  mesh {shape}, fsdp {fsdps}: {shape[0] * shape[1]} ranks in "
            f"{time.perf_counter() - t0} s")
    ref = runs[(1, 1)][0]["a"]
    ref_b = runs[(1, 1)][0]["b"]["losses"]
    worst = {"loss": 0.0, "grad_norm": 0.0, "bf16_loss": 0.0}
    launches = {}
    gate_mesh_runs(runs, ref, ref_b, "16a", "16b", worst, launches)
    worst_d = {"loss": 0.0, "grad_norm": 0.0, "bf16_loss": 0.0}
    gate_mesh_runs(fsdp_runs, ref, ref_b, "16d f32", "16d bf16", worst_d, launches)
    c = [r["c"] for r in runs[(2, 2)]]
    say(f"[16c] compressed_psum of {MESH_PSUM} f32 a rank over 4 ranks (gloo): CUDA "
        f"against CPU max abs err {[x['max_abs_err'] for x in c]} (one int8 step of "
        f"the agreed scale {c[0]['step']}; gates: 0, and within 4 steps), "
        f"{[x['us'] for x in c]} us on CUDA tensors, {[x['us_cpu'] for x in c]} us "
        f"on CPU copies")
    if max(x["max_abs_err"] for x in c) > 4 * c[0]["step"]:
        raise AssertionError(f"phase 16c: compressed_psum CUDA vs CPU: {c}")
    if max(x["max_abs_err"] for x in c) != 0:
        raise AssertionError(f"phase 16c: compressed_psum CUDA and CPU part: {c}")
    say(f"  phase 16a gates: worst relative loss {worst['loss']} (limit "
        f"{MESH_LOSS_REL}), grad norm {worst['grad_norm']} (limit {MESH_GNORM_REL}); "
        f"16b: worst relative bf16 loss {worst['bf16_loss']} (limit {MESH_BF16_LOSS_REL}); "
        f"16d: loss {worst_d['loss']}, grad norm {worst_d['grad_norm']}, bf16 loss "
        f"{worst_d['bf16_loss']}")

    def plain(res):
        return [{k: v for k, v in r.items() if k != "a"} |
                {"a": {k: v for k, v in r["a"].items() if k != "sums"}} for r in res]
    return dict(runs={f"{s[0]}x{s[1]}": plain(res) for s, res in runs.items()},
                fsdp_runs={f"{s[0]}x{s[1]}": plain(res) for s, res in fsdp_runs.items()},
                worst=worst, worst_fsdp=worst_d, launches=launches)


# -- phase 17: the dry run against the card ---------------------------------------------

SWEEP_WORKERS = 8          # the card machine's host cores
SWEEP_TIMEOUT_S = 300.0
# every family splits over the model axis: only the quadratic archs'
# long_500k cells are skipped
SWEEP_COUNTS = {"ok": 33, "skipped": 7, "error": 0}
# one sweep worker: ``launch.dryrun``'s main on each cell it claims, in turn,
# in one process (the first count's imports are paid once).  Every worker
# walks the whole list, heaviest cells first, and runs a cell only where it
# creates the cell's claim file first, so the cells spread over the workers
# as they free up.  Prints each cell's seconds; exit 1 if a cell failed.
# ``full`` counts the recurrent families at full depth (no depth probes)
SWEEP_WORKER = """
import os, sys, time
from repro_torch.launch import dryrun
out, mode, cells = sys.argv[1], sys.argv[2], sys.argv[3:]
if mode == "full":
    dryrun.depth_probes = lambda cfg: None
rc = 0
for i, cell in enumerate(cells):
    try:
        os.close(os.open(os.path.join(out, f"claim{i}"), os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        continue
    arch, shape = cell.split(":")
    t = time.perf_counter()
    try:
        dryrun.main(["--arch", arch, "--shape", shape, "--no-probes", "--out",
                     os.path.join(out, "cells")])
    except SystemExit:
        rc = 1
    print(f"cell {arch} {shape} {time.perf_counter() - t:.1f} s", flush=True)
sys.exit(rc)
"""


class DryRunSweep:
    """``launch.dryrun --no-probes`` at (16, 16) over the 40 cells (or
    ``cells``), on the host (meta tensors; no card), in ``workers``
    processes that claim the cells in turn, heaviest first: the recurrent
    families' train and prefill cells, then the train, prefill, decode
    and long cells.  It is started only after the last timed phase, so no
    reading shares the host with it; :meth:`stop` ends whatever still
    runs.  ``full_depth``: the recurrent families counted at full depth."""

    def __init__(self, cells=None, workers: int = SWEEP_WORKERS,
                 full_depth: bool = False) -> None:
        from repro_torch.configs import ARCHS, SHAPES, get_config
        self.dir = tempfile.TemporaryDirectory(prefix="dryrun-")
        order = {s.name: i for i, s in enumerate(SHAPES)}

        def heavy(cell):
            a, s = cell
            scans = get_config(a).family in ("ssm", "hybrid") and order[s] < 2
            return (not scans, order[s])
        self.cells = sorted(cells or [(a, s.name) for s in SHAPES for a in ARCHS],
                            key=heavy)
        self.workers, self.full_depth = workers, full_depth
        self.procs = []

    def result(self, timeout: float = SWEEP_TIMEOUT_S) -> dict:
        env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": "",
               "OMP_NUM_THREADS": "1"}
        t0 = time.perf_counter()
        for w in range(self.workers):
            log = Path(self.dir.name) / f"worker{w}.log"
            with open(log, "w") as f:
                proc = subprocess.Popen(
                    [sys.executable, "-c", SWEEP_WORKER, self.dir.name,
                     "full" if self.full_depth else "probes",
                     *(f"{a}:{s}" for a, s in self.cells)],
                    stdout=f, stderr=subprocess.STDOUT, env=env)
            proc.log = log
            self.procs.append(proc)
        try:
            rcs = [proc.wait(timeout=max(0.0, timeout - (time.perf_counter() - t0)))
                   for proc in self.procs]
        except subprocess.TimeoutExpired:
            return dict(rc=None, counts=None, lines=[], wall_s=time.perf_counter() - t0,
                        timed_out=f"{sum(p.poll() is None for p in self.procs)} of "
                                  f"{self.workers} workers running after {timeout} s")
        lines = [x for proc in self.procs for x in proc.log.read_text().splitlines()]
        counts = {"ok": 0, "skipped": 0, "error": 0}
        for line in lines:
            m = re.match(r"cells: (\d+) ok, (\d+) skipped, (\d+) error", line)
            if m:
                for k, n in zip(("ok", "skipped", "error"), map(int, m.groups())):
                    counts[k] += n
        if sum(counts.values()) != len(self.cells):
            counts = None       # a worker that died before its cells' tallies
        return dict(rc=max(rcs), counts=counts, lines=lines,
                    wall_s=time.perf_counter() - t0)

    def stop(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        self.procs = []
        self.dir.cleanup()


def phase_dry_run(train_mesh):
    """Phase 17 (a)-(c): the dry run (meta device) of phase 16's model
    against the card's readings."""
    from repro_torch.launch import dryrun, roofline
    cfg = mesh_cfg("bfloat16")
    say("[17] the dry run against the card: phase 16's bf16 model, 2 x 4096 tokens")
    out = {"meshes": {}}
    # (a) a rank's build peak against the dry run's state bytes
    for key, fsdp in (("runs", False), ("fsdp_runs", True)):
        for name, res in train_mesh[key].items():
            shape = tuple(int(x) for x in name.split("x"))
            built = mesh_build(cfg, shape, fsdp)
            state = sum(t.nbytes for t in torch_leaves(built.state))
            args = sum(t.nbytes for t in torch_leaves(built.args))
            peaks = [r["b"]["init_peak_bytes"] for r in res]
            out["meshes"][f"{name}{' fsdp' if fsdp else ''}"] = dict(
                state_bytes=state, arg_bytes=args, build_peaks=peaks)
            say(f"  [17a] {shape}{' fsdp' if fsdp else ''}: dry run state a rank {state} B "
                f"(arguments {args} B); build peaks {peaks} B (gate: within "
                f"[{state - 4}, {state + MESH_BUILD_SLACK}])")
            for p in peaks:
                if not state - 4 <= p <= state + MESH_BUILD_SLACK:
                    raise AssertionError(f"phase 17a: {shape} fsdp={fsdp}: build peak {p} "
                                         f"B outside the dry run's {state} B + "
                                         f"{MESH_BUILD_SLACK}")
    # (b) the (1, 1) step's peak, seconds and roofline; the fsdp meshes'
    # counted collectives beside the measured ones
    counted = {}
    for shape, fsdp in (((1, 1), False), *((s, True) for s in FSDP_SHAPES)):
        c = dryrun.count(mesh_build(cfg, shape, fsdp))
        counted[shape] = c
    one = train_mesh["runs"]["1x1"][0]["b"]
    c = counted[(1, 1)]
    built = mesh_build(cfg, (1, 1), False)
    state = sum(t.nbytes for t in torch_leaves(built.state))
    grads = sum(t.nbytes for t in torch_leaves(built.args[0]))
    rl = roofline.derive(roofline.Probe(c["flops"], c["bytes_accessed"],
                                        float(c["collectives"]["total"])),
                         model_flops_per_device=6.0 * cfg.param_count()
                         * MESH_BF16[0] * MESH_BF16[1])
    rl.memory_floor_s = (sum(t.nbytes for t in torch_leaves(built.args)) + c["saved"]) \
        / roofline.HBM_BW
    measured_s = float(np.median(one["step_s"]))
    out["one"] = dict(step_peak_bytes=one["peak_bytes"], state_bytes=state,
                      grad_bytes=grads, saved_bytes=c["saved"], flops=c["flops"],
                      bytes_accessed=c["bytes_accessed"], roofline=rl.as_dict(),
                      measured_step_s=measured_s, share=rl.step_s / measured_s,
                      floor_share=max(rl.compute_s, rl.memory_floor_s) / measured_s)
    say(f"  [17b] (1, 1): step peak {one['peak_bytes']} B measured, against the dry "
        f"run's state {state} B + gradients {grads} B + saved for backward "
        f"{c['saved']} B = {state + grads + c['saved']} B; step {measured_s} s "
        f"measured, roofline step_s {rl.step_s} s ({rl.dominant}; compute "
        f"{rl.compute_s} s for {c['flops']} FLOPs, memory {rl.memory_s} s for "
        f"{c['bytes_accessed']} B accessed, touch-once floor {rl.memory_floor_s} s): "
        f"share {rl.step_s / measured_s}, against the floor "
        f"{out['one']['floor_share']}")
    for shape in FSDP_SHAPES:
        coll = counted[shape]["collectives"]
        us = train_mesh["fsdp_runs"][f"{shape[0]}x{shape[1]}"][0]["b"]["fsdp_us_a_step"]
        say(f"  [17c] {shape} fsdp: counted a step {coll} B; measured rank 0 "
            f"all-gather {us['all-gather']} us, reduce-scatter {us['reduce-scatter']} us "
            f"a step ({coll['all-gather'] / max(us['all-gather'], 1e-9)} B/us, "
            f"{coll['reduce-scatter'] / max(us['reduce-scatter'], 1e-9)} B/us)")
        out[f"collectives {shape}"] = dict(counted=coll, measured_us=us)
    return out


def phase_dry_run_sweep():
    """Phase 17d: the 40-cell sweep at (16, 16), after every timed phase."""
    sweep = DryRunSweep()
    try:
        res = sweep.result()
    finally:
        sweep.stop()
    say(f"  [17d] dry run --no-probes at (16, 16), the 40 cells in {SWEEP_WORKERS} "
        f"worker processes after the last timed phase: {res['counts']} in {res['wall_s']} s, "
        f"worst exit {res['rc']}")
    for line in res["lines"]:
        if line.startswith("[FAIL]") or line.startswith("[ok]"):
            say(f"    {line}")
    if res.get("timed_out"):
        raise AssertionError(f"phase 17d: dry-run sweep: {res['timed_out']}")
    if res["rc"] != 0 or res["counts"] != SWEEP_COUNTS:
        raise AssertionError(f"phase 17d: dry-run sweep: {res['counts']} (expected "
                             f"{SWEEP_COUNTS}), exit {res['rc']}: "
                             + "\n".join(res["lines"][-20:]))
    return {k: v for k, v in res.items() if k != "lines"}


def torch_leaves(tree):
    import torch
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


# -- phase 18: the recurrent and encoder-decoder families on the mesh -------------------

# Every rank a process of its own on FAM_DEVICE over gloo, as in phases 15 and
# 16, one spawn a mesh shape running all of its cases; the (1, 1) references
# run in this process first.  (a) zamba2-1.2b at full width and depth, flash
# pinned: f32 FAM_F32 at (1, 1), (1, 2), (2, 2); bf16 FAM_BF16 at (1, 1),
# (1, 2).  (b) rwkv6-7b at full width cut to RWKV_MESH_LAYERS layers, f32
# FAM_F32 at (1, 1), (1, 2), (1, 4).  (c) whisper-base whole, f32
# WHISPER_F32 with 1500 seeded frames, at (1, 1), (1, 2).  (d) lockstep
# prefill and FAM_LOCK_NEW decode steps of the three at full width, bf16, 4
# rows, at (1, 2) against (1, 1); the reduced configs in f32 at (1, 2) and
# (1, 4) against (1, 1), token for token.
FAM_DEVICE = "cuda:0"
FAM_SEED = 18
# f32: 3 steps, the last one's loss and grad norm after an update (the
# learning rate is 0 at step 0)
FAM_F32 = (2, 1024, 3)              # global batch, sequence, steps
FAM_BF16 = (1, 4096, 1, 2)          # global batch, sequence, warm-up, timed steps
# the learning rate ramps over this many steps (3e-5 at the first update).
# AdamW's first step moves every weight by +-lr, the sign of each near-zero
# gradient decided by its rounding: at the full rate (3e-4) it lifts
# random-weight zamba2-1.2b's loss from 10.9 to 12.4 (f32) or 13.5 (bf16),
# and the ranks' other roundings then part the next bf16 loss from (1, 1)'s
# by 5.4e-4 and the next f32 grad norm at (2, 2) by 2.3e-4 on an H100
# (PERF.md), chaos that says nothing of the split
FAM_LR_RAMP = 10
WHISPER_F32 = (2, 256, 2)           # global batch, decoder tokens, steps
# 4 layers of rwkv6-7b at full width: 1.41 B parameters, 22.6 GB of f32
# state at (1, 1); at (1, 4) a rank holds the 0.54 B of embed and lm_head
# and cr whole and a quarter of the rest: ~0.80 B, 12.9 GB, 51.6 GB for the
# four ranks together
RWKV_MESH_LAYERS = 4
FAM_LOCK_NEW = 16
# what each mesh shape runs (the (1, 1) row: this process)
FAM_CASES = {
    (1, 1): ("a", "a_bf16", "b", "c", "d", "d_reduced"),
    (1, 2): ("a", "a_bf16", "b", "c", "d", "d_reduced"),
    (2, 2): ("a",),
    (1, 4): ("b", "d_reduced"),
}
# the flash kernel at a rank's heads on these paths (Hq, Hkv, S, T, D,
# causal): zamba2's shared block at (1, 2) in training (1024, 4096) and in
# the lockstep prefill (512); whisper's 4 heads a rank, the encoder over
# 1500 frames, the decoder's self- (256) and cross-attention
FAM_SHARD_FLASH_CASES = ((16, 16, 1024, 1024, 64, True), (16, 16, 4096, 4096, 64, True),
                         (16, 16, 512, 512, 64, True), (4, 4, 1500, 1500, 64, False),
                         (4, 4, 256, 256, 64, True), (4, 4, 256, 1500, 64, False))


class FamFrames:
    """A token stream with seeded stub frames (B, 1500, 512) beside each
    batch, for whisper-base's training (the frames are the model's input;
    ``SyntheticStream`` yields none)."""

    def __init__(self, cfg, batch, seq):
        from repro_torch.data import DataConfig, SyntheticStream
        self.cfg, self.batch = cfg, batch
        self.base = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                               global_batch=batch, seed=FAM_SEED))

    def batch_at(self, step):
        out = dict(self.base.batch_at(step))
        rng = np.random.default_rng((FAM_SEED, step))
        out["frames"] = rng.standard_normal(
            (self.batch, self.cfg.source_len, self.cfg.d_model)).astype(np.float32)
        return out


def fam_cfg(name, dtype, layers=None):
    from repro_torch.configs import get_config
    cfg = get_config(name)
    kw = dict(dtype=dtype)
    if not cfg.attention_free:
        kw["attn_impl"] = "flash_cuda"
    if layers:
        kw["num_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def fam_train(group, shape, name, dtype, sizes, layers=None):
    """One training run of ``name`` on this rank of ``shape`` (``group``
    None: (1, 1) in this process): losses, grad norms, step seconds, peak
    memory (and while the loop is built), flash launches of the timed
    steps (zeroed just before them), the shard's heads, the leaves' bit
    sums, and on a mesh the µs of the gradient sync and of an activation
    all-reduce over the model group."""
    import torch
    import torch.distributed as dist
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.distributed import sharding
    from repro_torch.distributed.group import MeshGroups
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
    batch, seq, warm, steps = sizes if len(sizes) == 4 else (*sizes[:2], 0, sizes[2])
    cfg = fam_cfg(name, dtype, layers)
    data = (FamFrames(cfg, batch, seq) if cfg.family == "encdec" else
            SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                       global_batch=batch, seed=FAM_SEED)))
    lc = TrainLoopConfig(total_steps=warm + steps, warmup_steps=FAM_LR_RAMP,
                         log_every=0, enable_vpe=False, watchdog=False)
    mesh = MeshGroups(group, *shape) if group is not None else None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(cfg, lc, data, seed=FAM_SEED, device=FAM_DEVICE, mesh=mesh)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() - base
    if warm:
        loop.run(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    metrics = loop.run(warm + steps)[-steps:]
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    local = loop.local_cfg
    out = dict(
        # 2 an attention a step under remat (forward and recompute; the
        # backward runs the reference's VJP)
        expected=2 * flash_per_prefill(cfg) * steps,
        name=name, dtype=dtype, rank=group.rank if group is not None else 0,
        d=loop.mesh.groups.d if loop.mesh else 0, m=loop.mesh.groups.m if loop.mesh else 0,
        losses=[m["loss"] for m in metrics], gnorms=[m["grad_norm"] for m in metrics],
        step_s=[m["step_time_s"] for m in metrics],
        tokens_per_s=batch * seq / float(np.median([m["step_time_s"] for m in metrics])),
        peak_bytes=torch.cuda.max_memory_allocated() - base, build_peak_bytes=build_peak,
        state_bytes=tree_bytes((loop.params, loop.opt_state)), launches=launches,
        heads=(local.num_heads, local.num_kv_heads), d_ff=local.d_ff,
        mixer_heads=sharding.mixer_heads(cfg) // getattr(local, "mixer_shards", 1),
        sums=bit_sums(loop.params) if shape[0] > 1 else None,
        split=[k for k, _ in sharding._walk(loop.params)
               if shape[1] > 1 and sharding.splits_leaf(cfg, shape[1], k)])
    if loop.mesh is not None:
        leaves = torch.utils._pytree.tree_leaves(loop.params)
        grads = [torch.zeros_like(p) for p in leaves]
        out["grad_bytes"] = tree_bytes(grads)
        out["grad_all_reduce_us"] = fenced_us(lambda: loop.mesh.sync(grads), iters=1)
        del grads
        if shape[1] > 1:
            rows = batch // shape[0] if batch % shape[0] == 0 else batch
            x = torch.ones((rows, seq, cfg.d_model), device=FAM_DEVICE)
            out["act_bytes"] = x.numel() * 4
            out["act_all_reduce_us"] = fenced_us(
                lambda: dist.all_reduce(x, group=loop.mesh.groups.model))
            del x
    del loop, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fam_lock_inputs(cfg, reduced):
    """4 rows of prompts (left-padded to a multiple of the scan chunks: 64-512
    tokens at full width) and, for whisper, seeded frames, made on the host
    from seeds (the same on every rank)."""
    import torch
    if cfg.family == "encdec":
        waves = family_waves(cfg, (16,) if reduced else (WHISPER_WAVES[1],), seed=FAM_SEED)
        gen = torch.Generator().manual_seed(FAM_SEED)
        frames = torch.randn((FAMILY_SLOTS, cfg.source_len, cfg.d_model), generator=gen)
        return np.stack(waves[0]), frames.to(getattr(torch, cfg.dtype))
    lens = ((16, 9, 32, 20),) if reduced else (FAMILY_WAVES[1],)
    return left_padded(family_waves(cfg, lens, seed=FAM_SEED)[0]), None


def fam_lockstep(group, shape, name, reduced):
    """``model.prefill`` and FAM_LOCK_NEW greedy ``decode_step``s of ``name``
    (full width bf16, or reduced f32) on this rank of ``shape`` under its
    scope, each rank drawing only its slice of the seeded weights: the
    tokens, each step's top-2 margin, the flash launches (zeroed just
    before) and the walls."""
    import contextlib

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.group import MeshGroups
    from repro_torch.distributed.sharding import mixer_heads
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.train_loop import MeshShard
    cfg = get_config(name).reduced() if reduced else fam_cfg(name, "bfloat16")
    if reduced and not cfg.attention_free:
        cfg = dataclasses.replace(cfg, attn_impl="flash_cuda")
    shard = MeshShard(cfg, MeshGroups(group, *shape)) if group is not None else None
    keep = shard.keep if shard is not None and shard.scope is not None else None
    params = model_lib.init_params(cfg, torch.Generator(FAM_DEVICE).manual_seed(FAM_SEED),
                                   keep=keep)
    local = shard.local_cfg if shard is not None else cfg
    toks, frames = fam_lock_inputs(cfg, reduced)
    batch = {"tokens": torch.as_tensor(toks, device=FAM_DEVICE)}
    if frames is not None:
        batch["frames"] = frames.to(FAM_DEVICE)
    scope = shard.context() if shard is not None else contextlib.nullcontext()
    tokens, margins, walls = [], [], []
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    with torch.no_grad(), scope:
        t0 = time.perf_counter()
        cache = model_lib.init_cache(local, toks.shape[0], FAMILY_MAX_LEN, FAM_DEVICE)
        cache, logits = model_lib.prefill(local, params, batch, cache)
        for i in range(FAM_LOCK_NEW + 1):
            last = logits[:, -1].float()
            top = last.topk(2, dim=-1).values
            tok = last.argmax(-1)
            tokens.append(tok.cpu().numpy())
            margins.append((top[:, 0] - top[:, 1]).cpu().numpy())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i == FAM_LOCK_NEW:
                break
            t0 = time.perf_counter()
            cache, logits = model_lib.decode_step(local, params, cache,
                                                  tok[:, None].to(torch.int32))
    launches = fa.flash_attention_cuda.launches
    out = dict(name=name, reduced=reduced, rank=group.rank if group is not None else 0,
               expected=flash_per_prefill(cfg),
               tokens=np.stack(tokens, 1), margins=np.stack(margins, 1),
               prefill_s=walls[0], decode_ms=float(np.mean(walls[1:])) * 1e3,
               launches=launches, heads=(local.num_heads, local.num_kv_heads),
               mixer_heads=mixer_heads(cfg) // getattr(local, "mixer_shards", 1),
               finite=bool(torch.isfinite(logits).all()))
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fam_rank(group, shape):
    """Every case of phase 18 for ``shape`` on this rank (``group`` None: the
    (1, 1) references in this process)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for case in FAM_CASES[shape]:
        t0 = time.perf_counter()
        if case == "a":
            out[case] = fam_train(group, shape, "zamba2-1.2b", "float32", FAM_F32)
        elif case == "a_bf16":
            out[case] = fam_train(group, shape, "zamba2-1.2b", "bfloat16", FAM_BF16)
        elif case == "b":
            out[case] = fam_train(group, shape, "rwkv6-7b", "float32", FAM_F32,
                                  layers=RWKV_MESH_LAYERS)
        elif case == "c":
            out[case] = fam_train(group, shape, "whisper-base", "float32", WHISPER_F32)
        else:
            out[case] = {name: fam_lockstep(group, shape, name, case == "d_reduced")
                         for name in ("zamba2-1.2b", "rwkv6-7b", "whisper-base")}
        out[f"{case}_s"] = time.perf_counter() - t0
    return out


def fam_flash_checks(dev):
    """The flash kernel at a rank's heads on phase 18's paths against its
    plain version, bf16 and f32, with phase 3's tolerances."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(dev).manual_seed(FAM_SEED)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for Hq, Hkv, S, T, D, causal in FAM_SHARD_FLASH_CASES:
            q, k, v = flash_inputs(gen, dtype, Hq, Hkv, S, T, D)
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = ref.attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = max(err, check_close(
                f"[18] flash at a rank's heads {str(dtype)[6:]} Hq={Hq} Hkv={Hkv} D={D} "
                f"S={S} T={T} causal={causal}", got, want, *flash_tolerance(dtype)))
            del q, k, v, got, want
    return err


def gate_fam_train(runs, case, tag, worst, launches):
    """18a/b/c's gates of every rank of every mesh against (1, 1)'s run of
    ``case``; prints each rank's line."""
    ref = runs[(1, 1)][0][case]
    bf16 = ref["dtype"] == "bfloat16"
    for shape, res in runs.items():
        if shape == (1, 1) or case not in res[0]:
            continue
        for r in (x[case] for x in res):
            rl = max(abs(x - y) / abs(y) for x, y in zip(r["losses"], ref["losses"]))
            rg = max(abs(x - y) / abs(y) for x, y in zip(r["gnorms"], ref["gnorms"]))
            expected = r["expected"]
            launches[f"{tag} {r['name']} {shape[0]}x{shape[1]} rank {r['rank']}"] = \
                r["launches"]
            say(f"  [{tag}] {r['name']} {r['dtype']} {shape} rank {r['rank']} (d, m) = "
                f"({r['d']}, {r['m']}): attention heads {r['heads']}, mixer heads "
                f"{r['mixer_heads']}, d_ff {r['d_ff']}; losses {r['losses']}, grad norms "
                f"{r['gnorms']} (worst relative against (1, 1): loss {rl}, grad norm {rg}); "
                f"step seconds {r['step_s']} (the slowest rank's), {r['tokens_per_s']} "
                f"tokens/s of the mesh; peak memory {r['peak_bytes']} B, while built "
                f"{r['build_peak_bytes']} B, state {r['state_bytes']} B; gradient sync "
                f"{r.get('grad_all_reduce_us')} us for {r.get('grad_bytes')} B, activation "
                f"all-reduce {r.get('act_all_reduce_us')} us for {r.get('act_bytes')} B; "
                f"flash launches {r['launches']} ({r['launches'] / len(r['losses'])} a "
                f"step, expected {expected})")
            key = "bf16_loss" if bf16 else "loss"
            worst[key] = max(worst[key], rl)
            if not bf16:
                worst["grad_norm"] = max(worst["grad_norm"], rg)
            if not all(np.isfinite(r["losses"])):
                raise AssertionError(f"phase {tag}: {shape} rank {r['rank']}: losses "
                                     f"{r['losses']}")
            if (bf16 and rl > MESH_BF16_LOSS_REL) or (
                    not bf16 and (rl > MESH_LOSS_REL or rg > MESH_GNORM_REL)):
                raise AssertionError(f"phase {tag}: {r['name']} {shape} rank {r['rank']}: "
                                     f"losses {r['losses']} / grad norms {r['gnorms']} "
                                     f"against {ref['losses']} / {ref['gnorms']}")
            if r["launches"] != expected:
                raise AssertionError(f"phase {tag}: {r['name']} {shape} rank {r['rank']}: "
                                     f"flash launches {r['launches']} != {expected}")
        if shape[0] > 1:
            # a leaf no rank splits is the same bits on every rank; every
            # leaf on every data rank of one model index
            rs = [x[case] for x in res]
            for key, n in rs[0]["sums"].items():
                holders = [r for r in rs if key not in rs[0]["split"] or r["m"] == 0]
                if any(r["sums"][key] != n for r in holders):
                    raise AssertionError(f"phase {tag}: {shape}: leaf {key} differs across "
                                         f"the ranks that hold it whole")
            for r in rs:
                if r["sums"] != rs[r["m"]]["sums"]:
                    raise AssertionError(f"phase {tag}: {shape}: rank {r['rank']}'s leaves "
                                         f"differ from data rank 0's")


def gate_fam_lockstep(runs, case, tag, launches):
    """18d's gates: every rank's tokens the same; against (1, 1)'s, equal
    (reduced f32), or parting only where (1, 1)'s top-2 margin is at most
    TIE_MARGIN (full width, bf16); finite logits; flash launched once an
    attention of the prefill on every rank."""
    out = {}
    for name, ref in runs[(1, 1)][0][case].items():
        for shape, res in runs.items():
            if shape == (1, 1) or case not in res[0]:
                continue
            rs = [x[case][name] for x in res]
            for r in rs[1:]:
                if not np.array_equal(r["tokens"], rs[0]["tokens"]):
                    raise AssertionError(f"phase {tag}: {name} {shape}: ranks' tokens differ")
            got, want = rs[0]["tokens"], ref["tokens"]
            partings = []
            for row in range(want.shape[0]):
                diff = np.nonzero(got[row] != want[row])[0]
                if len(diff):
                    j = int(diff[0])
                    partings.append((row, j, float(ref["margins"][row, j])))
            expected = ref["expected"]
            for r in rs:
                launches[f"{tag} {name} {shape[0]}x{shape[1]} rank {r['rank']}"] = \
                    r["launches"]
            say(f"  [{tag}] {name}{' reduced f32' if ref['reduced'] else ' bf16'} {shape}: "
                f"attention heads a rank {rs[0]['heads']}, mixer heads {rs[0]['mixer_heads']}; "
                f"{want.shape[0]} rows x {want.shape[1]} tokens, partings from (1, 1) "
                f"(row, step, (1, 1)'s top-2 margin) {partings}; prefill {rs[0]['prefill_s']} "
                f"s, decode {rs[0]['decode_ms']} ms a step (1, 1): {ref['prefill_s']} s, "
                f"{ref['decode_ms']} ms; flash launches {[r['launches'] for r in rs]} "
                f"(expected {expected} a rank)")
            out[f"{name} {shape}"] = dict(partings=partings, prefill_s=rs[0]["prefill_s"],
                                          decode_ms=rs[0]["decode_ms"])
            if not all(r["finite"] for r in rs):
                raise AssertionError(f"phase {tag}: {name} {shape}: non-finite logits")
            if any(r["launches"] != expected for r in rs):
                raise AssertionError(f"phase {tag}: {name} {shape}: flash launches "
                                     f"{[r['launches'] for r in rs]} != {expected}")
            if ref["reduced"] and partings:
                raise AssertionError(f"phase {tag}: reduced {name} {shape}: tokens part "
                                     f"from (1, 1)'s: {partings}")
            if any(m > TIE_MARGIN for _, _, m in partings):
                raise AssertionError(f"phase {tag}: {name} {shape}: tokens part from "
                                     f"(1, 1)'s at a margin above {TIE_MARGIN}: {partings}")
    return out


def phase_family_mesh(dev):
    """Phase 18: the recurrent and encoder-decoder families on the (data,
    model) mesh (see the constants)."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.group import spawn_ranks
    from repro_torch.launch import specs
    t_phase = time.perf_counter()
    say(f"[18] the recurrent and encoder-decoder families on the mesh: zamba2-1.2b at "
        f"full width and depth (18a), rwkv6-7b at full width cut to {RWKV_MESH_LAYERS} "
        f"layers (18b), whisper-base (18c), lockstep serving of the three (18d); (1, 1) "
        f"in this process, the meshes {[s for s in FAM_CASES if s != (1, 1)]} as rank "
        f"processes on {FAM_DEVICE} over gloo")
    err = fam_flash_checks(dev)
    gc.collect()
    torch.cuda.empty_cache()
    runs = {(1, 1): [fam_rank(None, (1, 1))]}
    for shape in FAM_CASES:
        if shape == (1, 1):
            continue
        t0 = time.perf_counter()
        runs[shape] = spawn_ranks(fam_rank, [FAM_DEVICE] * (shape[0] * shape[1]), (shape,))
        say(f"  mesh {shape}: {shape[0] * shape[1]} ranks in {time.perf_counter() - t0} s "
            f"(cases {FAM_CASES[shape]}, rank 0's seconds "
            f"{ {k: v for k, v in runs[shape][0].items() if k.endswith('_s')} })")
    worst = {"loss": 0.0, "grad_norm": 0.0, "bf16_loss": 0.0}
    launches = {}
    for case, tag in (("a", "18a"), ("a_bf16", "18a bf16"), ("b", "18b"), ("c", "18c")):
        r11 = runs[(1, 1)][0][case]
        say(f"  [{tag}] {r11['name']} {r11['dtype']} (1, 1): losses {r11['losses']}, grad "
            f"norms {r11['gnorms']}, step seconds {r11['step_s']}, {r11['tokens_per_s']} "
            f"tokens/s, peak memory {r11['peak_bytes']} B, state {r11['state_bytes']} B, "
            f"flash launches {r11['launches']}")
        launches[f"{tag} {r11['name']} 1x1"] = r11["launches"]
        gate_fam_train(runs, case, tag, worst, launches)
    # the (1, 2) bf16 run's build peak against the dry run's state a rank
    cfg = fam_cfg("zamba2-1.2b", "bfloat16")
    built = specs.build_train(cfg, ShapeConfig("fam", "train", FAM_BF16[1], FAM_BF16[0]),
                              specs.dry_mesh(1, 2), fsdp=False, tp=True)
    state = specs.tree_bytes(built.state)
    peaks = [r["a_bf16"]["build_peak_bytes"] for r in runs[(1, 2)]]
    say(f"  [18a] (1, 2) bf16: dry run state a rank {state} B; build peaks {peaks} B (gate: "
        f"within [{state - 4}, {state + MESH_BUILD_SLACK}])")
    for p in peaks:
        if not state - 4 <= p <= state + MESH_BUILD_SLACK:
            raise AssertionError(f"phase 18a: (1, 2) build peak {p} B outside the dry run's "
                                 f"{state} B + {MESH_BUILD_SLACK}")
    lock = gate_fam_lockstep(runs, "d", "18d", launches)
    lock.update(gate_fam_lockstep(runs, "d_reduced", "18d reduced", launches))
    wall = time.perf_counter() - t_phase
    say(f"  phase 18 gates: f32 worst relative loss {worst['loss']}, grad norm "
        f"{worst['grad_norm']} (limits {MESH_LOSS_REL}, {MESH_GNORM_REL}); bf16 loss "
        f"{worst['bf16_loss']} (limit {MESH_BF16_LOSS_REL}); flash at a rank's heads max "
        f"abs err {err}; phase 18 wall {wall} s")

    def plain(r):
        return {k: ({n: {kk: vv for kk, vv in x.items() if kk not in ("tokens", "margins")}
                     for n, x in v.items()} if k in ("d", "d_reduced") else
                    {kk: vv for kk, vv in v.items() if kk != "sums"}
                    if isinstance(v, dict) else v) for k, v in r.items()}
    return dict(runs={f"{s[0]}x{s[1]}": [plain(r) for r in res] for s, res in runs.items()},
                worst=worst, lockstep=lock, launches=launches, flash_err=err,
                build=dict(state_bytes=state, peaks=peaks), wall_s=wall)


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
    each); None unless the profiler shows that many.  Late in a long
    process a profiler session loses the first records of its window
    (PERF.md section 7), hence the calls beyond the measured ones."""
    from torch.autograd import DeviceType
    fn()

    def calls():
        for _ in range(warmup + iters):
            flush.zero_()
            fn()

    prof, _ = profile_window(calls)
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


# phase 14: two engine replicas of the main path's engine on one card
REPLICAS = 2
REPLICA_DEVICES = ["cuda:0"] * REPLICAS
# 14b's failover plan on reduced qwen3-8b (group of 2, 2 slots a replica):
# the dispatch site's call 1 (the second handoff, to replica 1) is lost
# and retried, so replica 1 starts a group step late and its first
# admissions prefill in 16-token chunks: the decode site's calls 0 and 1
# are replica 0's (the scheduling is the host's, the same on the CPU as
# on the card).  The first demotes replica 0's decode_cuda rung, the
# second finds no rung left and charges its requests; at a budget of 2
# that quarantines replica 0.  No request reaches its fault budget of 3
# (one charge a fault, one a migration), so none fails.
FAILOVER_SPECS = (("decode", "device", 0), ("decode", "device", 1),
                  ("dispatch", "device", 1))
FAILOVER_BUDGET = 2


def phase_replicas(cfg, params, dev, prompts):
    """Phase 14a: full-width qwen3-8b through ``make_serve_engine(mesh_shape
    =(2, 1))`` with both replicas on one card (one copy of the weights), the
    main path's engine settings, and 16 requests (phase 4's 8 and 8 more
    from the same generator).  The reference is a single engine serving the
    same 16 requests in this process.  Each replica is warmed by a request
    of its own, which captures its decode graph; the launch counts are
    zeroed just before the timed run and read just after.  Gates: every
    request done with 32 tokens, each replica admitted at least 4, the
    pools audit-clean and drained, no capture in the timed run, decode
    launches one a layer a step and prefill launches one a layer a chunk,
    the single engine's tokens or a parting at a near-tie (top-2 margin <=
    0.25), first-token logits within 0.25 of it, and the shared VPE's keys
    labelled ``xmesh:dp2mp1``."""
    import torch
    from repro_torch.core import VPE, bucket_label
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.runtime.serve_loop import (EngineReplicaGroup, Request,
                                                ServeStats, make_serve_engine)
    say(f"[14a] replicas: {cfg.name} at full width, make_serve_engine(mesh_shape=("
        f"{REPLICAS}, 1), mesh_devices={REPLICA_DEVICES}), the main path's engine "
        f"a replica, {len(prompts)} requests")
    warm = np.arange(1, 200, dtype=np.int32)
    single = serving_engine(cfg, params, dev, 1)
    warm_up(single, warm)
    ref = serve_traffic(single, cfg, prompts, "phase 14a single engine")
    del single
    gc.collect()
    torch.cuda.empty_cache()
    # the main path's engine settings (serving_engine), a VPE shared
    group = make_serve_engine(
        cfg, params, mesh_shape=(REPLICAS, 1), mesh_devices=REPLICA_DEVICES,
        slots=SLOTS, max_len=MAX_LEN, block_size=BS, kv_layout="paged",
        prefill_chunk=CHUNK, decode_horizon=1, decode_impl="cuda",
        prefill_kernel="cuda", vpe=VPE())
    if not isinstance(group, EngineReplicaGroup) or any(
            e.params is not params for e in group.engines):
        raise AssertionError("phase 14a: not a group of replicas sharing the weights")
    for eng in group.engines:
        warm_up(eng, warm)
        eng.stats = ServeStats()
        eng.completed.clear()
        eng.first_logits = {}
    graphs = [e.graphs for e in group.engines]
    before = [(g.captures, g.replays, g.replayed_calls) for g in graphs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    walls, both = [], []
    step = group.step

    def work():
        return [(len(e.stats.queue_wait_s), e.stats.prefill_chunks,
                 sum(e.stats.horizon_hist.values())) for e in group.engines]

    def timed_step():
        w0 = work()
        t = time.perf_counter()
        out = step()
        walls.append(time.perf_counter() - t)
        # a step in which both replicas only decoded: no admission, no
        # chunk, one decode call each
        if all(a1 == a0 and c1 == c0 and d1 == d0 + 1
               for (a0, c0, d0), (a1, c1, d1) in zip(w0, work())):
            both.append(walls[-1])
        return out

    group.step = timed_step
    t0 = time.perf_counter()
    try:
        for i, p in enumerate(prompts):
            group.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
        done = group.run()
        torch.cuda.synchronize()
    finally:
        del group.step
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = group.stats
    replayed = sum(g.replayed_calls - b[2] for g, b in zip(graphs, before))
    captures = [g.captures - b[0] for g, b in zip(graphs, before)]
    launches = {"paged_decode_attention": pa.paged_attention_cuda.launches + replayed,
                "paged_prefill_attention": pa.paged_prefill_attention_cuda.launches}
    per_replica = []
    for r, (eng, g, b) in enumerate(zip(group.engines, graphs, before)):
        pool = sum(t.numel() * t.element_size() for t in eng.page_pool.values())
        per_replica.append(dict(
            device=str(eng.device), admits=len(eng.stats.queue_wait_s),
            completed=len(eng.completed), decode_steps=eng.stats.decode_steps,
            captures=g.captures, captures_in_run=g.captures - b[0],
            replays_in_run=g.replays - b[1], pool_bytes=pool,
            graph_pool_bytes=g.pool_bytes()))
        say(f"  replica {r} on {eng.device}: {per_replica[-1]}")
    run = dict(
        wall_s=wall, decode_steps=st.decode_steps, prefill_chunks=st.prefill_chunks,
        mean_ttft_s=st.mean_ttft_s, max_ttft_s=max(st.ttft_s),
        decode_tok_per_s=st.decode_tok_per_s,
        tok_per_s_end_to_end=st.tokens_out / wall,
        group_steps=len(walls), group_step_us=sum(walls) / len(walls) * 1e6,
        decode_only_steps=len(both),
        decode_only_step_us=sum(both) / len(both) * 1e6 if both else None,
        peak_bytes=peak, launches=launches, replicas=per_replica,
        tokens={r.rid: r.out for r in done if r.status == "done"},
        first_logits={rid: x.float() for e in group.engines
                      for rid, x in e.first_logits.items()})
    say(f"  group: {st.summary()}")
    say(f"  wall {wall} s, {len(walls)} group steps, {run['group_step_us']} us a "
        f"group step (host; {len(both)} steps in which both replicas only decoded: "
        f"{run['decode_only_step_us']} us a step), TTFT mean {st.mean_ttft_s} s max {run['max_ttft_s']} s, "
        f"decode {st.decode_tok_per_s} tok/s (over the replicas' summed decode "
        f"walls), {run['tok_per_s_end_to_end']} tok/s end to end, peak "
        f"{peak} B, launches {launches} (decode: {replayed} in graph replays); "
        f"single engine: decode {ref['decode_tok_per_s']} tok/s, TTFT mean "
        f"{ref['mean_ttft_s']} s, wall {ref['wall_s']} s")
    if len(done) != len(prompts) or any(
            r.status != "done" or len(r.out) != NEW_TOKENS
            or not all(0 <= t < cfg.vocab_size for t in r.out) for r in done):
        raise AssertionError(f"phase 14a: requests not completed: "
                             f"{[(r.rid, r.status, len(r.out)) for r in done]}")
    if any(p["admits"] < len(prompts) // (2 * REPLICAS) for p in per_replica):
        raise AssertionError(f"phase 14a: a replica admitted too few: {per_replica}")
    group.check_kv()
    if any(e.pages.num_live or any(s.pages for s in e.slots) for e in group.engines):
        raise AssertionError("phase 14a: a replica's pool is not drained")
    if any(captures):
        raise AssertionError(f"phase 14a: captures in the timed run: {captures}")
    if launches["paged_decode_attention"] != st.decode_steps * cfg.num_layers or \
            launches["paged_prefill_attention"] != st.prefill_chunks * cfg.num_layers:
        raise AssertionError(f"phase 14a: launches {launches} do not match "
                             f"{st.decode_steps} steps and {st.prefill_chunks} chunks "
                             f"x {cfg.num_layers} layers")
    run["vs_single"] = compare_runs("phase 14a", "the single engine", ref, run, cfg,
                                    params, prompts, atol=TIE_MARGIN, tie=TIE_MARGIN)
    labels = sorted({bucket_label(b) for b in
                     group.engines[0].vpe.profiler.buckets_seen("serve_decode_impl")})
    say(f"  shared VPE's serve_decode_impl keys: {labels}")
    if not labels or not all(lb.endswith("xmesh:dp2mp1") for lb in labels):
        raise AssertionError(f"phase 14a: keys without the mesh: {labels}")
    run["labels"] = labels
    run.pop("first_logits")
    run["single"] = {k: ref[k] for k in ("wall_s", "decode_tok_per_s", "mean_ttft_s",
                                         "decode_steps", "launches")}
    return run


def phase_failover(dev):
    """Phase 14b: replica failover on the card.  Reduced qwen3-8b in f32, a
    group of 2 on one card (paged, both kernels pinned, 2 slots a replica),
    a plan of device faults at replica 0's decode calls and one lost
    dispatch, ``replica_fault_budget=2``.  Gates: the plan fired whole,
    both decode faults on replica 0, at least one quarantine and one
    re-admission, the group healthy at the end, no canary in
    ``completed``, every request done with the tokens of a clean single
    engine on the same requests, no failure (the plan charges no request
    3 faults), the pools audit-clean and drained."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_faults import FaultPlan, FaultSpec
    from repro_torch.runtime.serve_loop import Request, make_serve_engine
    cfg = get_config("qwen3-8b").reduced()
    params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(2))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 60, 8)]
    kw = dict(slots=2, max_len=96, block_size=BS, prefill_chunk=16)
    clean = run_engine(cfg, params, dev, ("cuda", "cuda"), prompts, 12, **kw)
    plan = FaultPlan([FaultSpec(*f) for f in FAILOVER_SPECS])
    group = make_serve_engine(
        cfg, params, mesh_shape=(REPLICAS, 1), mesh_devices=REPLICA_DEVICES,
        kv_layout="paged", decode_impl="cuda", prefill_kernel="cuda",
        fault_plan=plan, replica_fault_budget=FAILOVER_BUDGET, **kw)
    for i, p in enumerate(prompts):
        group.submit(Request(rid=i, prompt=p, max_new_tokens=12))
    done = group.run()
    torch.cuda.synchronize()
    st = group.stats
    faults = [e.stats.device_faults for e in group.engines]
    got = {r.rid: r.out for r in done if r.status == "done"}
    fired = [(f.site, f.kind, f.at) for f in plan.injected]
    out = dict(fired=fired, quarantines=st.replica_quarantines,
               readmissions=st.replica_readmissions, canaries=st.canary_probes,
               device_faults_by_replica=faults, demotions=dict(st.demotions),
               failed_by_reason=dict(st.failed_by_reason),
               dispatch_faults=list(group._dispatch_faults),
               tokens_equal=got == clean)
    say(f"[14b] failover: reduced {cfg.name} ({cfg.dtype}), group of {REPLICAS} on "
        f"{REPLICA_DEVICES}, plan {list(FAILOVER_SPECS)}, budget {FAILOVER_BUDGET}: "
        f"{st.summary()}; {out}")
    if sorted(fired) != sorted(FAILOVER_SPECS) or faults != [2, 0]:
        raise AssertionError(f"phase 14b: the plan did not land as planned: {out}")
    if st.replica_quarantines < 1 or st.replica_readmissions < 1 or group.quarantined:
        raise AssertionError(f"phase 14b: no quarantine and re-admission: {out}")
    if sorted(r.rid for r in done) != list(range(len(prompts))):
        raise AssertionError(f"phase 14b: completed holds {[r.rid for r in done]}")
    if st.failed_by_reason or got != clean:
        raise AssertionError(f"phase 14b: failures or tokens off the clean run: "
                             f"{out}\n clean {clean}\n got {got}")
    group.check_kv()
    if any(not e.pages.drained for e in group.engines):
        raise AssertionError("phase 14b: a replica's pool is not drained")
    return out


# phase 15: head sharding, mp ranks (one process each) time-sharing one
# card over gloo (NCCL refuses two ranks on one card)
SHARD_MP = 2
SHARD_DEVICES = ["cuda:0"] * SHARD_MP
# 15b: qwen3-8b's heads on a rank at mp = 2 and 4
SHARD_HEADS = ((HQ // 2, HKV // 2), (HQ // 4, HKV // 4))
# 15a's token gate: a parting from phase 4's tokens only at a top-2 margin
# this close (a sharded rank sums each down-projection's f32 partials in
# another order than the single engine's GEMM, and rounds once as it does)
SHARD_TIE = 0.0625
# 15c: reduced qwen3-8b in f32 (weights seed 2), 8 prompts of 5-59 tokens,
# 12 new tokens, both kernels pinned (they run at mp = 2, one KV head a
# rank, and at mp = 4, where Hkv = 2 does not split: each rank holds the
# KV head its one query head reads)
SHARD_REDUCED_KW = dict(slots=2, max_len=96, block_size=BS, prefill_chunk=16,
                        kv_layout="paged")
SHARD_REDUCED_MESHES = ((1, 2), (1, 4))


def shard_reduced_case(dev):
    """15c's reduced config, weights and prompts (the same on every rank:
    one seed, one card)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    cfg = get_config("qwen3-8b").reduced()
    params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(2))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 60, 8)]
    return cfg, params, prompts


def shard_reduced_rank(group, mesh):
    """15c on one rank: reduced qwen3-8b sharded over ``mesh``; its tokens,
    the kernel launches and the shard's heads."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.runtime.serve_loop import Request, make_serve_engine
    dev = torch.device("cuda", 0)
    cfg, params, prompts = shard_reduced_case(dev)
    eng = make_serve_engine(cfg, params, mesh_shape=mesh,
                            mesh_devices=["cuda:0"] * mesh[1], shard_group=group,
                            decode_impl="cuda", prefill_kernel="cuda",
                            **SHARD_REDUCED_KW)
    pa.reset_launch_counts()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=12))
    done = eng.run()
    torch.cuda.synchronize()
    eng.check_kv()
    return dict(tokens={r.rid: r.out for r in done if r.status == "done"},
                launches=(pa.paged_attention_cuda.launches,
                          pa.paged_prefill_attention_cuda.launches),
                heads=(eng.cfg.num_heads, eng.cfg.num_kv_heads),
                resolved=(eng._resolve_impl("cuda"), eng._resolve_kernel("cuda")),
                mismatch=eng.stats.shard_token_mismatch, drained=eng.pages.drained)


def shard_main_rank(group, prompts, warm):
    """15a on one rank, then 15c's (1, 2) case: full-width qwen3-8b drawn
    from phase 4's seed, sharded at (1, 2) by ``make_serve_engine`` (the
    whole weights dropped once the shard is copied), the main path's
    engine settings (paged, both kernels pinned, H = 1; eager: a sharded
    rank replays no graph), warmed by one request; phase 4's requests
    served with the launch counts zeroed just before and read just after,
    each decode-only step's host wall kept."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import VPE
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_loop import Request, ServeStats, make_serve_engine
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(0))
    eng = make_serve_engine(
        cfg, params, mesh_shape=(1, SHARD_MP), mesh_devices=SHARD_DEVICES,
        shard_group=group, slots=SLOTS, max_len=MAX_LEN, block_size=BS,
        kv_layout="paged", prefill_chunk=CHUNK, decode_horizon=1,
        decode_impl="cuda", prefill_kernel="cuda", vpe=VPE())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    warm_up(eng, warm)
    eng.stats = ServeStats()
    eng.completed.clear()
    eng.first_logits = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    walls, decode_only = [], []
    step = eng.step

    def timed_step():
        st = eng.stats
        before = (len(st.queue_wait_s), st.prefill_chunks, st.decode_steps)
        t = time.perf_counter()
        out = step()
        walls.append(time.perf_counter() - t)
        if (len(st.queue_wait_s), st.prefill_chunks) == before[:2] \
                and st.decode_steps == before[2] + 1:
            decode_only.append(walls[-1])
        return out

    eng.step = timed_step
    t0 = time.perf_counter()
    try:
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
        done = eng.run()
        torch.cuda.synchronize()
    finally:
        del eng.step
    wall = time.perf_counter() - t0
    st = eng.stats
    eng.check_kv()
    out = dict(
        rank=group.rank, backend=group.backend, build_s=build_s,
        weight_bytes=tree_bytes(eng.params), pool_bytes=tree_bytes(eng.page_pool),
        heads=(eng.cfg.num_heads, eng.cfg.num_kv_heads), d_ff=eng.cfg.d_ff,
        peak_bytes=torch.cuda.max_memory_allocated(), wall_s=wall,
        decode_steps=st.decode_steps, prefill_chunks=st.prefill_chunks,
        decode_tok_per_s=st.decode_tok_per_s, mean_ttft_s=st.mean_ttft_s,
        tok_per_s_end_to_end=st.tokens_out / wall,
        steps=len(walls), step_ms=sum(walls) / len(walls) * 1e3,
        decode_only_steps=len(decode_only),
        decode_step_ms=(sum(decode_only) / len(decode_only) * 1e3
                        if decode_only else None),
        decode_step_ms_median=(float(np.median(decode_only)) * 1e3
                               if decode_only else None),
        launches={"paged_decode_attention": pa.paged_attention_cuda.launches,
                  "paged_prefill_attention": pa.paged_prefill_attention_cuda.launches},
        mismatch=st.shard_token_mismatch, drained=eng.pages.drained,
        status={r.rid: (r.status, len(r.out)) for r in done},
        tokens={r.rid: r.out for r in done if r.status == "done"},
        first_logits=({rid: x.float().cpu().numpy() for rid, x in eng.first_logits.items()}
                      if group.rank == 0 else {}),
        summary=st.summary())
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["reduced"] = shard_reduced_rank(group, (1, SHARD_MP))
    return out


def phase_head_sharding(dev, main, main_logits, errors):
    """Phase 15: head sharding (``mp > 1``) on the card.

    (a) full-width qwen3-8b in bf16 at mesh (1, 2): two ranks, each a
    process of its own (``spawn_ranks``) on ``cuda:0`` over gloo, each
    holding 16 of the 32 query heads, 4 of the 8 KV heads and half the
    FFN, serving phase 4's requests on the main path's engine (eager).
    Gates: every request done with 32 tokens, both paged kernels launched
    on each rank, one a layer a decode step and one a layer a chunk, no
    rank's own tokens differing from rank 0's, the pools drained, and the
    tokens phase 4's or parting only at a top-2 margin <= ``SHARD_TIE``.
    (b) both paged kernels against their plain versions at the shards'
    head counts (16/4 and 8/2).  (c) reduced qwen3-8b in f32 at (1, 2)
    and (1, 4) on the card: token for token a single engine's, both
    kernels launched on every rank.  The parent holds no model while the
    ranks run."""
    import torch
    from repro_torch.distributed.group import spawn_ranks
    prompts = traffic(VOCAB)
    say(f"[15a] head sharding: qwen3-8b at full width, mesh (1, {SHARD_MP}), ranks "
        f"on {SHARD_DEVICES} (gloo), the main path's engine a rank, "
        f"{len(prompts)} requests")
    t0 = time.perf_counter()
    ranks = spawn_ranks(shard_main_rank, SHARD_DEVICES,
                        (prompts, np.arange(1, 200, dtype=np.int32)))
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        say(f"  rank {r['rank']} ({r['backend']}): heads {r['heads']}, d_ff {r['d_ff']}, "
            f"weights {r['weight_bytes']} B, pool {r['pool_bytes']} B, peak "
            f"{r['peak_bytes']} B, built in {r['build_s']} s; {r['decode_steps']} decode "
            f"steps, {r['prefill_chunks']} chunks, {r['steps']} engine steps of "
            f"{r['step_ms']} ms, decode-only steps {r['decode_only_steps']} of "
            f"{r['decode_step_ms']} ms (median {r['decode_step_ms_median']}), decode "
            f"{r['decode_tok_per_s']} tok/s, TTFT mean {r['mean_ttft_s']} s, wall "
            f"{r['wall_s']} s, {r['tok_per_s_end_to_end']} tok/s end to end, launches "
            f"{r['launches']}, token mismatches {r['mismatch']}")
    say(f"  rank 0: {r0['summary']}; the spawn took {spawn_s} s; phase 4 (one engine, "
        f"graph replays): decode {main['decode_tok_per_s']} tok/s, "
        f"{main['decode_us_per_step']} us a decode step, TTFT mean "
        f"{main['mean_ttft_s']} s")
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-8b")
    layers = cfg.num_layers
    for r in ranks:
        if any(st != ("done", NEW_TOKENS) for st in r["status"].values()) or \
                len(r["status"]) != len(prompts):
            raise AssertionError(f"phase 15a: rank {r['rank']}: requests not done: "
                                 f"{r['status']}")
        if r["launches"]["paged_decode_attention"] != r["decode_steps"] * layers or \
                r["launches"]["paged_prefill_attention"] != r["prefill_chunks"] * layers \
                or not r["decode_steps"] or not r["prefill_chunks"]:
            raise AssertionError(f"phase 15a: rank {r['rank']}: launches {r['launches']} "
                                 f"do not match {r['decode_steps']} steps and "
                                 f"{r['prefill_chunks']} chunks x {layers} layers")
        if r["mismatch"] or not r["drained"] or r["tokens"] != r0["tokens"]:
            raise AssertionError(f"phase 15a: rank {r['rank']}: token mismatches "
                                 f"{r['mismatch']}, drained {r['drained']}")
    run = dict(tokens=r0["tokens"],
               first_logits={rid: torch.from_numpy(x) for rid, x in r0["first_logits"].items()})
    ref = dict(tokens=main["tokens"], first_logits=main_logits)
    params = None
    if run["tokens"] != ref["tokens"]:
        # the margins at a parting come from a full forward in this process
        from repro_torch.models import model as model_lib
        params = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(0))
    vs4 = compare_runs("phase 15a", "phase 4", ref, run, cfg, params, prompts,
                       tie=SHARD_TIE)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    say(f"[15b] paged kernels at the shards' heads (Hq/Hkv {SHARD_HEADS})")
    check_paged_kernels(torch.Generator(dev).manual_seed(15), SHARD_HEADS, errors)

    cfg, params, rprompts = shard_reduced_case(dev)
    want = run_engine(cfg, params, dev, ("cuda", "cuda"), rprompts, 12, **SHARD_REDUCED_KW)
    del params
    reduced = {(1, SHARD_MP): [r["reduced"] for r in ranks]}
    for mesh in SHARD_REDUCED_MESHES:
        if mesh not in reduced:
            reduced[mesh] = spawn_ranks(shard_reduced_rank, ["cuda:0"] * mesh[1], (mesh,))
    out_c = {}
    for mesh, res in reduced.items():
        say(f"[15c] reduced {cfg.name} (f32) at mesh {mesh}: per rank heads "
            f"{[r['heads'] for r in res]}, resolved {res[0]['resolved']}, launches "
            f"{[r['launches'] for r in res]}, tokens equal to one engine's "
            f"{[r['tokens'] == want for r in res]}, mismatches "
            f"{[r['mismatch'] for r in res]}")
        for r in res:
            if r["tokens"] != want or r["mismatch"] or not r["drained"]:
                raise AssertionError(f"phase 15c: mesh {mesh}: tokens {r['tokens']} "
                                     f"against {want}")
            if min(r["launches"]) <= 0 or r["resolved"] != ("cuda", "cuda"):
                raise AssertionError(f"phase 15c: mesh {mesh}: launches {r['launches']}, "
                                     f"resolved {r['resolved']}")
        out_c[f"{mesh[0]}x{mesh[1]}"] = dict(heads=[r["heads"] for r in res],
                                              launches=[r["launches"] for r in res],
                                              resolved=res[0]["resolved"])
    return dict(ranks=[{k: v for k, v in r.items()
                        if k not in ("tokens", "first_logits", "reduced", "status")}
                       for r in ranks],
                spawn_s=spawn_s, vs_phase4=vs4,
                launches={f"15a rank {r['rank']}": r["launches"] for r in ranks},
                reduced=out_c)


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
    return run_phases(args, dev, t_start)


def run_phases(args, dev, t_start) -> int:
    import torch

    from repro_torch.configs import get_config
    smi = phase_environment()
    phase_build()
    errors = phase_kernel_checks(dev)
    times = phase_kernel_times(dev, [len(p) for p in traffic(VOCAB)])
    errors["flash_attention"] = phase_flash_checks(dev)
    errors["flash_attention_bwd"] = phase_flash_bwd_checks(dev)
    say("[3d] flash kernel times at the training path's shapes (median of 20 "
        "calls, L2 flushed before each): forward, then backward")
    times["flash_attention"] = phase_flash_time(dev, get_config(TRAIN_ARCH))
    times["flash_attention_bwd"] = phase_flash_bwd_time(dev, get_config(TRAIN_ARCH))
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
    # phase 15 compares with phase 4's first-token logits after the model
    # is freed
    main_logits_host = {rid: x.float().cpu() for rid, x in main_logits.items()}
    del main_logits, cold_4d
    phase_reduced_parity(dev)
    logits = phase_full_width_parity(cfg, params, dev, prompts[:SLOTS], atol=0.25)
    # each path's launches, zeroed just before its run and read just after;
    # a kernel's "launches" is its main path's (phase 4's for the paged
    # kernels, training's for flash, the paper path's for matmul, conv2d)
    by_path = {name: {"4 main path": n} for name, n in main_run["launches"].items()}
    replicas = phase_replicas(cfg, params, dev,
                              traffic(cfg.vocab_size, more=REQUESTS))
    replicas["failover"] = phase_failover(dev)
    del params                      # the later phases need the card
    gc.collect()
    torch.cuda.empty_cache()
    shard = phase_head_sharding(dev, main_run, main_logits_host, errors)
    for path, counts in [("14a replicas", replicas["launches"]),
                         *shard["launches"].items()]:
        for name, n in counts.items():
            by_path[name][path] = n
    traces = None
    if args.trace:
        say("[6] traces (torch.profiler, in a child process)")
        traces = in_child("child_trace_main", dev, args.trace)
    moe = phase_moe(dev, args.trace)
    families = phase_families(dev)
    train = phase_train(dev, args.trace)
    train_parity = phase_train_parity(dev)
    main_run["launches"]["flash_attention"] = train["launches"]
    by_path["flash_attention"] = {"7 training": train["launches"]}
    main_run["launches"]["flash_attention_bwd"] = train["bwd_launches"]
    by_path["flash_attention_bwd"] = {"7 training": train["bwd_launches"]}
    train_mesh = phase_train_mesh(dev)
    by_path["flash_attention"].update(train_mesh["launches"])
    dry_run = phase_dry_run(train_mesh)
    families_mesh = phase_family_mesh(dev)
    by_path["flash_attention"].update(families_mesh["launches"])
    paper_errors = phase_paper_kernel_checks(dev)
    paper_times = phase_paper_kernel_times(dev)
    paper = phase_paper_path(dev)
    main_run["launches"].update(paper["launches"])
    by_path.update({name: {"11 paper path": n} for name, n in paper["launches"].items()})
    times.update(paper_times)
    # the paper path runs f32: its kernels' line holds their f32 errors
    # (bf16 errors are printed in phase 9 and kept in the report)
    errors.update({name: e["float32"] for name, e in paper_errors.items()})
    dry_run["sweep"] = phase_dry_run_sweep()

    kernels = []
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "flash_attention", "flash_attention_bwd", "matmul", "conv2d"):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": main_run["launches"][name],
            "launches_by_path": by_path[name],
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
                 faults=faults, replicas=replicas, head_sharding=shard,
                 full_width_logits=logits, traces=traces, moe=moe,
                 families=families, train=train,
                 train_parity=train_parity, train_mesh=train_mesh, dry_run=dry_run,
                 families_mesh=families_mesh,
                 paper_check_errors=paper_errors,
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
