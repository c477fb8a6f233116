"""CUDA-graph capture and replay of the serve engine's decode calls.

The counterpart of the reference engine's per-(variant, H) jit cache
(``repro.runtime.serve_loop.ContinuousBatchingEngine._decode_fn`` and
``_fused_fn``).  JAX compiles a decode call once and dispatches it once;
PyTorch runs eagerly, so one decode step of the port issues some sixty
small operations a layer from the host, and the card waits on the host.
A :class:`DecodeGraphs` owns one engine's decode calls: each is the fused
decode function of the engine's KV layout over its buffers
(:func:`repro_torch.models.model.decode_steps_paged`, ``_slots`` for the
contiguous layout, ``_mixed`` for ``auto``), captured in a
``torch.cuda.CUDAGraph`` at the first call of its (decode-attention
variant, H) and replayed from then on — one launch a call.  The layout is
fixed for the object's life, so each engine has a graph per (layout,
variant, H).  On the CPU the same function runs eagerly.

A graph reads and writes fixed addresses, so every tensor it touches
lives as long as the engine and is written in place, never rebound: the
(5, B) int32 input block (the rows ``tok``, ``live``, ``eos`` with -1 for
none, ``paged``, the ``auto`` layout's per-slot mask of slots that decode
through the pool, and ``budget``), the cache (the contiguous K/V and
lengths, and the block table), the page pool and the weights.  The
captured call ends by copying its final tokens into ``tok``, so a steady
decode needs no upload.

Capture changes nothing a later read sees: the warm-up that precedes it
(one eager call on the capture stream, which sets up cuBLAS for that
stream and raises the decode kernel's shared-memory limit outside the
capture) and the capture itself run with ``live`` at zero, so no length
moves and every page append goes to the trash page.  A contiguous write
still lands in each slot's own rows at its current length: a position
the slot's next real step writes before it reads it, or one that its
length masks.  The real mask is restored after.  A failed capture or
replay raises; there is no eager retry.

Launch counts: the decode kernel's wrapper counts its calls in Python,
so it counts the warm-up's launches and the capture's recorded calls, and
never a replay.  A :class:`DecodeGraphs` does not touch that counter: it
keeps its own count of replays and of the wrapper calls they stand for
(``replayed_calls``, each replay adding the calls its capture recorded).
Whether a replay really runs the kernel is for a device-side measurement
to show (``chip_smoke.py`` reads it from the profiler).

Speculative verify calls (:meth:`DecodeGraphs.verify`) follow the same
rules, one graph per span S: the (B, S) int32 token block is a static
buffer of its own that each call fills in place from a pinned host
tensor, ``live``, ``eos`` and ``budget`` are the input rows above, the
captured call ends by copying its final tokens into ``tok``, and the
capture (warm-up included) runs with ``live`` at zero, so every page
write goes to the trash page, the contiguous writes of ``auto`` rewrite
what is there and no length moves.  The verify read is the gather path
and launches no kernel of the port.

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

INPUT_ROWS = ("tok", "live", "eos", "paged", "budget")


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor          # (2, B, H) int32: token block, valid mask
    kernel_calls: int          # decode-kernel wrapper calls it recorded
    replays: int = 0


class DecodeGraphs:
    """One engine's decode calls, captured per (variant, H) on the card
    for the engine's one layout.

    ``layout`` is the engine's KV layout (``"contiguous"``, ``"paged"`` or
    ``"auto"``); ``cache`` its
    cache (paged: block table and lengths; contiguous: the slot cache;
    ``auto``: the slot cache with the block table); ``pool`` its page pool
    (None for the contiguous layout); ``inputs`` its (5, B) int32 block of
    decode inputs, rows in :data:`INPUT_ROWS` order.  None of them may be
    rebound while this object lives."""

    def __init__(self, cfg: ModelConfig, params, layout: str, cache: Dict,
                 inputs: torch.Tensor, pool: Optional[Dict] = None) -> None:
        self.cfg = cfg
        self.params = params
        self.layout = layout
        self.pool = pool
        self.cache = cache
        self.tok, self.live, self.eos, self.paged, self.budget = inputs.unbind(0)
        self.device = inputs.device
        self.graphs: Dict[Tuple[str, int], _Graph] = {}
        self.captures = 0
        self.replays = 0
        self.replayed_calls = 0    # decode-kernel wrapper calls replayed
        # speculative verify: a graph, a token buffer and a pinned staging
        # tensor per span S
        self.verify_graphs: Dict[int, _Graph] = {}
        self.verify_tokens: Dict[int, torch.Tensor] = {}
        self._verify_host: Dict[int, torch.Tensor] = {}
        self.verify_captures = 0
        self.verify_replays = 0
        self._mem_pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            self._mem_pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def _call(self, impl: str, horizon: int) -> torch.Tensor:
        """One decode call over the engine's buffers; returns the (2, B, H)
        token block and valid mask, and leaves the final tokens in
        ``tok``."""
        args = (self.tok[:, None], self.live, self.eos, self.budget, horizon)
        if self.layout == "paged":
            *_, toks, valid, final = model_lib.decode_steps_paged(
                self.cfg, self.params, self.pool, self.cache, *args,
                decode_impl=impl)
        elif self.layout == "contiguous":
            *_, toks, valid, final = model_lib.decode_steps_slots(
                self.cfg, self.params, self.cache, *args, decode_impl=impl)
        else:
            *_, toks, valid, final = model_lib.decode_steps_mixed(
                self.cfg, self.params, self.cache, self.pool,
                self.tok[:, None], self.paged, *args[1:], decode_impl=impl)
        self.tok.copy_(final)
        return torch.stack((toks, valid))

    def launch(self, impl: str, horizon: int) -> Tuple[torch.Tensor, bool]:
        """One decode call of ``horizon`` steps with decode attention
        ``impl``, not fenced: the (2, B, H) token block and valid mask on
        the device, and whether this call captured its graph."""
        if self.device.type != "cuda":
            return self._call(impl, horizon), False
        entry = self.graphs.get((impl, horizon))
        captured = entry is None
        if captured:
            entry = self._capture(lambda: self._call(impl, horizon),
                                  kpa.paged_attention_cuda)
            self.graphs[(impl, horizon)] = entry
            self.captures += 1
        entry.graph.replay()
        entry.replays += 1
        self.replays += 1
        self.replayed_calls += entry.kernel_calls
        return entry.out, captured

    def run(self, impl: str, horizon: int
            ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """:meth:`launch`, then (tok_block (B, H), valid (B, H)) on the host
        — the copy is the call's fence — and whether it captured."""
        out, captured = self.launch(impl, horizon)
        out = out.cpu().numpy()
        return out[0], out[1], captured

    def replayed_calls_of(self, impl: str) -> int:
        """Decode-kernel wrapper calls the replays of ``impl``'s graphs
        stand for."""
        return sum(e.replays * e.kernel_calls
                   for (name, _), e in self.graphs.items() if name == impl)

    def _verify_call(self, span: int) -> torch.Tensor:
        """One verify call over the engine's buffers and the span's token
        buffer; returns the (2, B, S) token block and valid mask and leaves
        the final tokens in ``tok``."""
        toks = self.verify_tokens[span]
        if self.layout == "paged":
            *_, g, valid, final = model_lib.spec_verify_paged(
                self.cfg, self.params, self.pool, self.cache, toks, self.live,
                self.eos, self.budget)
        elif self.layout == "auto":
            *_, g, valid, final = model_lib.spec_verify_mixed(
                self.cfg, self.params, self.cache, self.pool, toks, self.paged,
                self.live, self.eos, self.budget)
        else:
            raise ValueError("speculative verify needs a block table "
                             "(the paged or auto layout)")
        self.tok.copy_(final)
        return torch.stack((g, valid))

    def verify(self, tokens: np.ndarray) -> Tuple[torch.Tensor, bool]:
        """One speculative verify call of the (B, S) int32 ``tokens`` (each
        slot's last token, then its drafts), not fenced: the (2, B, S)
        token block and valid mask on the device, and whether this call
        captured its graph.  The tokens are written in place into the
        span's static buffer."""
        span = int(tokens.shape[1])
        buf = self.verify_tokens.get(span)
        if buf is None:
            buf = torch.zeros(tokens.shape, dtype=torch.int32, device=self.device)
            self.verify_tokens[span] = buf
            if self.device.type == "cuda":
                self._verify_host[span] = torch.empty(
                    tokens.shape, dtype=torch.int32, pin_memory=True)
        if self.device.type != "cuda":
            buf.copy_(torch.from_numpy(np.ascontiguousarray(tokens, np.int32)))
            return self._verify_call(span), False
        host = self._verify_host[span]
        host.numpy()[...] = tokens
        buf.copy_(host, non_blocking=True)
        entry = self.verify_graphs.get(span)
        captured = entry is None
        if captured:
            entry = self._capture(lambda: self._verify_call(span), None)
            self.verify_graphs[span] = entry
            self.verify_captures += 1
        entry.graph.replay()
        entry.replays += 1
        self.verify_replays += 1
        return entry.out, captured

    def _capture(self, call, wrapper) -> _Graph:
        """Warm ``call`` up on the capture stream and capture it, with
        ``live`` at zero for both; ``wrapper``'s launch counter (a kernel
        wrapper, or None) gives the calls the capture recorded."""
        live = self.live.clone()
        self.live.zero_()
        try:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                call()
            graph = torch.cuda.CUDAGraph()
            mark = wrapper.launches if wrapper is not None else 0
            with torch.cuda.graph(graph, pool=self._mem_pool,
                                  stream=self._stream):
                out = call()
            calls = wrapper.launches - mark if wrapper is not None else 0
        finally:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
            self.live.copy_(live)
        return _Graph(graph, out, calls)

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds for this engine's graphs (0
        on the CPU)."""
        if self._mem_pool is None:
            return 0
        pool = tuple(self._mem_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)
