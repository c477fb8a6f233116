"""Continuous-batching serving example: slot recycling + prefix cache.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The counterpart of ``examples/serve_lm.py``.  Submits two bursts of
requests that share a long system prompt to the token-level
continuous-batching engine (reduced qwen3-8b).  The first burst is the
warm-up phase: prompts are prefilled in full and their KV blocks are
inserted into the radix-tree prefix cache.  The second burst hits the
cache — admission copies the shared prefix's pages into the freed slot
and prefills only each request's unique tail, cutting TTFT.  Both the
decode hot path (decode-attention variant, keyed by slot occupancy) and
the reuse policy (``prefix_reuse``: copy-in vs recompute, keyed by
matched-prefix length) are VPE-tuned online from measured wall time.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..configs import get_config
from ..core import VPE
from ..models import model
from ..runtime.serve_loop import ContinuousBatchingEngine, Request


def main(device: DeviceLike = "cuda") -> Dict[str, object]:
    """Serve both bursts on ``device``; returns the warm requests' tokens
    by request id, the two bursts' mean TTFT and the VPE's decision table
    (all printed)."""
    dev = resolve_device(device)
    cfg = get_config("qwen3-8b").reduced()
    params = model.init_params(cfg, torch.Generator(dev).manual_seed(0))
    vpe = VPE(controller_kwargs=dict(min_samples=3, trial_samples=3))
    engine = ContinuousBatchingEngine(cfg, params, slots=4, max_len=192,
                                      vpe=vpe, prefix_blocks=32, block_size=16,
                                      device=dev)

    rng = np.random.default_rng(0)
    system_prompt = rng.integers(0, cfg.vocab_size, 96).astype(np.int32)

    def burst(base_rid: int) -> None:
        for i in range(8):
            tail = rng.integers(0, cfg.vocab_size, 4 + (i % 5)).astype(np.int32)
            engine.submit(Request(
                rid=base_rid + i,
                prompt=np.concatenate([system_prompt, tail]),
                max_new_tokens=8 if i % 2 else 24))   # mixed output lengths

    t0 = time.perf_counter()
    burst(0)                      # cold: fills the radix tree
    engine.run()
    cold_ttft = engine.stats.mean_ttft_s
    burst(100)                    # warm: shared prefix served from cache
    done = engine.run()
    dt = time.perf_counter() - t0

    warm: List[Request] = sorted((r for r in done if r.rid >= 100),
                                 key=lambda r: r.rid)
    warm_ttft = sum(r.ttft_s for r in warm) / len(warm)
    for r in warm[:3]:
        print(f"request {r.rid}: admitted@step {r.admit_step}, "
              f"done@step {r.done_step}, out={list(r.out)[:8]}...")
    print(f"\n{len(done)} requests in {dt:.2f}s on {dev}; "
          f"{engine.stats.summary()}")
    print(f"mean ttft: cold burst {cold_ttft * 1e3:.1f}ms "
          f"-> warm burst {warm_ttft * 1e3:.1f}ms")
    report = vpe.report()
    print(report)
    return dict(tokens={r.rid: list(r.out) for r in warm},
                cold_ttft_s=cold_ttft, warm_ttft_s=warm_ttft, report=report)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    main(ap.parse_args().device)
