"""CUDA-graph capture and replay of the serve engine's decode calls.

The counterpart of the reference engine's per-(variant, H) jit cache
(``repro.runtime.serve_loop.ContinuousBatchingEngine._decode_fn`` and
``_fused_fn``).  JAX compiles a decode call once and dispatches it once;
PyTorch runs eagerly, so one decode step of the port issues some sixty
small operations a layer from the host, and the card waits on the host.
A :class:`DecodeGraphs` owns one engine's decode calls: each is
:func:`repro_torch.models.model.decode_steps_paged` over the engine's
buffers, captured in a ``torch.cuda.CUDAGraph`` at the first call of its
(decode-attention variant, H) and replayed from then on — one launch a
call.  On the CPU the same function runs eagerly.

A graph reads and writes fixed addresses, so every tensor it touches
lives as long as the engine and is written in place, never rebound: the
(4, B) int32 input block (the rows ``tok``, ``live``, ``eos`` with -1 for
none, ``budget``), the block table and lengths of the cache, the page
pool and the weights.  The captured call ends by copying its final tokens
into ``tok``, so a steady decode needs no upload.

Capture has no side effect: the warm-up that precedes it (one eager call
on the capture stream, which sets up cuBLAS for that stream and raises
the decode kernel's shared-memory limit outside the capture) and the
capture itself run with ``live`` at zero — every append goes to the trash
page and no length moves — and the real mask is restored after.  A
failed capture or replay raises; there is no eager retry.

Launch counts: the decode kernel's wrapper counts its calls in Python,
so it counts the warm-up's launches and the capture's recorded calls, and
never a replay.  A :class:`DecodeGraphs` does not touch that counter: it
keeps its own count of replays and of the wrapper calls they stand for
(``replayed_calls``, each replay adding the calls its capture recorded).
Whether a replay really runs the kernel is for a device-side measurement
to show (``chip_smoke.py`` reads it from the profiler).

All graphs of one engine share one memory pool.  That is safe because
they replay one at a time on one stream and each replay's outputs are
copied to the host before the next replay, which may reuse their memory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paged_attention as kpa
from repro_torch.models import model as model_lib

INPUT_ROWS = ("tok", "live", "eos", "budget")


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor          # (2, B, H) int32: token block, valid mask
    kernel_calls: int          # decode-kernel wrapper calls it recorded


class DecodeGraphs:
    """One engine's decode calls, captured per (variant, H) on the card.

    ``inputs`` is the engine's (4, B) int32 block of decode inputs, rows
    in :data:`INPUT_ROWS` order; ``pool`` and ``cache`` are its page pool
    and paged cache.  None of them may be rebound while this object
    lives."""

    def __init__(self, cfg: ModelConfig, params, pool: Dict, cache: Dict,
                 inputs: torch.Tensor) -> None:
        self.cfg = cfg
        self.params = params
        self.pool = pool
        self.cache = cache
        self.tok, self.live, self.eos, self.budget = inputs.unbind(0)
        self.device = inputs.device
        self.graphs: Dict[Tuple[str, int], _Graph] = {}
        self.captures = 0
        self.replays = 0
        self.replayed_calls = 0    # decode-kernel wrapper calls replayed
        self._mem_pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            self._mem_pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def _call(self, impl: str, horizon: int) -> torch.Tensor:
        """One decode call over the engine's buffers; returns the (2, B, H)
        token block and valid mask, and leaves the final tokens in
        ``tok``."""
        _, _, toks, valid, final = model_lib.decode_steps_paged(
            self.cfg, self.params, self.pool, self.cache, self.tok[:, None],
            self.live, self.eos, self.budget, horizon, decode_impl=impl)
        self.tok.copy_(final)
        return torch.stack((toks, valid))

    def run(self, impl: str, horizon: int
            ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """One decode call of ``horizon`` steps with decode attention
        ``impl``: (tok_block (B, H), valid (B, H)) on the host — the copy is
        the call's fence — and whether this call captured its graph."""
        if self.device.type != "cuda":
            out = self._call(impl, horizon).numpy()
            return out[0], out[1], False
        entry = self.graphs.get((impl, horizon))
        captured = entry is None
        if captured:
            entry = self._capture(impl, horizon)
        entry.graph.replay()
        self.replays += 1
        self.replayed_calls += entry.kernel_calls
        out = entry.out.cpu().numpy()
        return out[0], out[1], captured

    def _capture(self, impl: str, horizon: int) -> _Graph:
        live = self.live.clone()
        self.live.zero_()
        try:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                self._call(impl, horizon)
            graph = torch.cuda.CUDAGraph()
            mark = kpa.paged_attention_cuda.launches
            with torch.cuda.graph(graph, pool=self._mem_pool,
                                  stream=self._stream):
                out = self._call(impl, horizon)
            calls = kpa.paged_attention_cuda.launches - mark
        finally:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
            self.live.copy_(live)
        entry = _Graph(graph, out, calls)
        self.graphs[(impl, horizon)] = entry
        self.captures += 1
        return entry

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds for this engine's graphs (0
        on the CPU)."""
        if self._mem_pool is None:
            return 0
        pool = tuple(self._mem_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)
