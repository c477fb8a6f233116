#!/usr/bin/env python3
"""Device times of the port's kernels, for comparing two trees on one
card.

    PYTHONPATH=<tree>/src python3 tools/kernel_times.py LABEL

Builds the kernel library of the ``repro_torch`` found on ``PYTHONPATH``
and prints one line ``RESULT {...}``: the median of 20 calls, with the L2
cache flushed before each, in ms, of
- flash attention at h2o-danube-3-4b's training shape (B=1, Hq=32,
  Hkv=8, S=T=4096, D=120, causal), bf16 and f32; its backward kernel in
  bf16 from the forward's output and log-sum-exp (``flash_bwd_bf16``,
  where the tree has it) and, as the yardstick, SDPA's backward on the
  same inputs (``flash_bwd_bf16_sdpa``);
- paged prefill at the serving path's chunk (qwen3-8b heads, bs=16,
  C=128 at base 256), bf16 and f32;
- paged decode at its batch (B=4, lengths 461, 365, 309, 201): the bf16
  ``read_dtype`` body the engine runs and the f32 plain body, and, as the
  yardstick, SDPA on K/V gathered beforehand (``decode_bf16_sdpa``); and
  the host's time to enqueue one bf16 call (``decode_bf16_host_us``, mean
  of 200 calls, µs), since serving is bound by the host;
- matmul at 512^3 and 4096^3 f32, and ``torch.matmul`` on the same
  inputs (``..._torch``);
- conv2d at 512^2 * 5x5 f32.
The yardsticks are timed only: no kernel wrapper calls them.  To compare a
parent with a change, unpack the parent with ``git archive`` into a
directory that ``.gitignore`` lists and run, in one process each and all
on one card in one go: parent, change, change, parent.  Needs a CUDA
device and ``nvcc``; imports nothing of JAX.
"""

import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.kvcache import paged_gather_layer
    build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB

    def ms(fn, iters=20):
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

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    res = {"label": sys.argv[1] if len(sys.argv) > 1 else "",
           "card": torch.cuda.get_device_name(0)}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        q, k, v = (randn((1, h, 4096, 120), dt) for h in (32, 8, 8))
        res[f"flash_{name}"] = ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=True, window=4096))
        if dt == torch.bfloat16 and hasattr(fa, "flash_attention_bwd_cuda"):
            g = randn(q.shape, dt)
            out, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=4096,
                                               with_lse=True)
            res["flash_bwd_bf16"] = ms(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, out, lse, g, causal=True, window=4096))
            tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
            so = F.scaled_dot_product_attention(tq, tk, tv, is_causal=True, enable_gqa=True)
            res["flash_bwd_bf16_sdpa"] = ms(lambda: torch.autograd.grad(
                so, (tq, tk, tv), g, retain_graph=True))
            del g, out, lse, tq, tk, tv, so
        del q, k, v
        n_pages = 4 * 64 + 5
        kp, vp = (randn((n_pages, 8, 16, 128), dt) for _ in range(2))
        q = randn((1, 32, 128, 128), dt)
        bt = torch.randperm(n_pages, generator=gen, device=dev)[:64].reshape(1, 64).int()
        base = torch.tensor([256], dtype=torch.int32, device=dev)
        res[f"prefill_{name}"] = ms(lambda: pa.paged_prefill_attention_cuda(
            q, kp, vp, bt, base, chunk_len=128))
        qd = randn((4, 32, 1, 128), dt)
        btd = torch.randperm(n_pages, generator=gen, device=dev)[:256].reshape(4, 64).int()
        lengths = torch.tensor([461, 365, 309, 201], dtype=torch.int32, device=dev)
        read = torch.bfloat16 if dt == torch.bfloat16 else None
        res[f"decode_{name}"] = ms(lambda: pa.paged_attention_cuda(
            qd, kp, vp, btd, lengths, read_dtype=read))
        if dt == torch.bfloat16:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                pa.paged_attention_cuda(qd, kp, vp, btd, lengths, read_dtype=read)
            res["decode_bf16_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            kg, vg = paged_gather_layer(kp, vp, btd)
            col = torch.arange(64 * 16, device=dev)
            mask = (col[None, :] <= lengths[:, None].long())[:, None, None, :]
            res["decode_bf16_sdpa"] = ms(lambda: F.scaled_dot_product_attention(
                qd, kg, vg, attn_mask=mask, enable_gqa=True))
    for n in (512, 4096):
        a, b = randn((n, n), torch.float32), randn((n, n), torch.float32)
        res[f"matmul_{n}_f32"] = ms(lambda: kmm.matmul(a, b))
        res[f"matmul_{n}_f32_torch"] = ms(lambda: torch.matmul(a, b))
    x, taps = randn((512, 512), torch.float32), randn((5, 5), torch.float32)
    res["conv2d_512_5_f32"] = ms(lambda: kconv.conv2d(x, taps))
    print("RESULT", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
