"""Serving runtime: token-level continuous batching over the paged KV layout.

The counterpart of ``repro.runtime.serve_loop.ContinuousBatchingEngine``,
restricted to the main serving path: greedy decoding of a dense model with
``kv_layout="paged"``.  A request is *placed* (pages allocated, block-table
row installed), prefilled in chunks that read every earlier position in
place through its block table, then decoded until EOS or its token
budget retires it and frees its slot for the next
request in the queue.  A decode call advances every decoding slot by
one token, or by up to H tokens in one fused horizon (``decode_horizon``):
H single steps on the device, the greedy token of each feeding the next,
with the pages the horizon can write reserved before the call and those a
stopped slot left unused returned after it.

Three measured implementation axes (VPE, the paper's profile-guided
dispatch) pick the attention backends and the horizon when left at
``"auto"``:

* ``serve_decode_impl`` — ``grouped``/``flat`` attend over gathered pages,
  ``cuda`` scores pages in place through the decode kernel; keyed by slot
  occupancy and fed from the fenced wall of each decode step;
* ``prefill_kernel`` — ``gather`` or the ``cuda`` multi-query kernel for
  chunked prefill; keyed by prompt length × occupancy and fed from the
  summed chunk walls of an admission;
* ``decode_horizon`` — ``1`` or a fused horizon from ``horizon_choices``;
  keyed by queue depth × occupancy and fed from the per-token wall of the
  whole decode span.

A pinned ``"cuda"`` runs the kernel — or raises; there is no fallback
ladder.  On a CUDA device the kernels are built and launched once in the
constructor, so no timed step pays for ``nvcc`` or a first load, and every
decode call replays a CUDA graph captured at the first call of its
(decode-attention variant, H) (:mod:`repro_torch.runtime.decode_graphs`,
the counterpart of the reference's per-(variant, H) jit).  The call that
captured is the counterpart of a call that compiled: it is counted in
``stats.tainted_steps`` and feeds no axis.

Features of the reference engine outside this slice raise ``ValueError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, fence, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (VPE, decode_horizon_bucket, occupancy_bucket,
                              pad_to_bucket, prefill_chunk_bucket)
from repro_torch.models import kvcache
from repro_torch.models import model as model_lib
from repro_torch.runtime.decode_graphs import INPUT_ROWS, DecodeGraphs
from repro_torch.runtime.page_pool import PagePool

# serve-engine implementation axes (first = default)
SERVE_AXES: Dict[str, List[str]] = {
    "serve_decode_impl": [*kvcache.DECODE_ATTN_VARIANTS,
                          *kvcache.PAGED_KERNEL_IMPLS],
    "prefill_kernel": ["gather", "cuda"],
}

PRIORITY_CLASSES = ("interactive", "batch")

# reference engine features outside this slice -> the ROADMAP item (queue
# 1, "Modules still to port", item 8) that ports each
LATER = {
    "contiguous": "8(a) contiguous layout",
    "prefix_cache": "8(b) prefix cache",
    "auto_layout": "8(c) auto layout",
    "chunk_axis": "8(d) measured prefill-chunk axis",
    "preemption": "8(f) preemption, priority scheduling and swap",
    "speculation": "8(g) speculation",
    "faults": "8(h) faults and deadlines",
    "mesh": "8(i) mesh and replicas",
}


def not_ported(what: str, item: str) -> ValueError:
    return ValueError(f"{what} is not ported yet: ROADMAP queue 1, item "
                      f"{LATER[item]}")


def _intake_error(req: "Request", max_len: int) -> Optional[str]:
    """Why a submission can never be served, or None if it can."""
    need = len(req.prompt) + req.max_new_tokens
    if need > max_len:
        return (f"prompt+max_new_tokens={need} exceeds slot "
                f"capacity max_len={max_len}")
    if len(np.asarray(req.prompt)) == 0:
        return "empty prompt"
    if req.priority not in PRIORITY_CLASSES:
        return (f"unknown priority class {req.priority!r} "
                f"(choose from {PRIORITY_CLASSES})")
    return None


@dataclasses.dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0
    prefill_tokens: int = 0          # tokens produced by prefill, not decode
    decode_steps: int = 0
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    queue_wait_s: List[float] = dataclasses.field(default_factory=list)
    # placement wall per admission (page allocation + block-table install)
    kv_place_s: List[float] = dataclasses.field(default_factory=list)
    paged_admits: int = 0
    prefill_chunks: int = 0          # chunked-prefill calls
    # decode service interruption per engine step: the wall of the
    # admission + prefill-chunk phase ahead of a decode step, recorded
    # only when decoding slots were waiting
    decode_stall_s: List[float] = dataclasses.field(default_factory=list)
    # chunk budget per step that ran chunks — {budget: steps}
    chunk_budget_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    # never-admitted submissions and terminal failures by reason code
    rejected: int = 0
    failed_by_reason: Dict[str, int] = dataclasses.field(default_factory=dict)
    # fused decode horizons: multi-step decode calls, the tokens they
    # emitted, pages reserved for a horizon but returned unused (a stop
    # froze the slot first), and the horizon of every decode call — {H:
    # calls}, single steps under H=1
    horizon_calls: int = 0
    horizon_tokens: int = 0
    reserved_pages_rolled_back: int = 0
    horizon_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    # decode calls that captured their CUDA graph (kept out of the VPE)
    tainted_steps: int = 0

    @property
    def decode_tok_per_s(self) -> float:
        if not self.decode_s:
            return 0.0
        return (self.tokens_out - self.prefill_tokens) / self.decode_s

    @property
    def total_tok_per_s(self) -> float:
        """Aggregate throughput: useful tokens over prefill+decode wall."""
        wall = self.prefill_s + self.decode_s
        return self.tokens_out / wall if wall else 0.0

    @property
    def mean_ttft_s(self) -> float:
        return sum(self.ttft_s) / len(self.ttft_s) if self.ttft_s else 0.0

    @property
    def mean_queue_wait_s(self) -> float:
        """Mean queue wait over admitted requests."""
        return (sum(self.queue_wait_s) / len(self.queue_wait_s)
                if self.queue_wait_s else 0.0)

    @property
    def failed_requests(self) -> int:
        return sum(self.failed_by_reason.values())

    def summary(self) -> str:
        s = (f"{self.tokens_out} tok, {self.total_tok_per_s:.1f} tok/s agg "
             f"({self.decode_tok_per_s:.1f} decode), "
             f"ttft {self.mean_ttft_s * 1e3:.1f}ms, "
             f"queue {self.mean_queue_wait_s * 1e3:.1f}ms")
        if self.paged_admits:
            s += f", paged {self.paged_admits} admits"
        if self.prefill_chunks:
            s += f", {self.prefill_chunks} prefill chunks"
        if self.horizon_calls:
            s += (f", {self.horizon_calls} fused horizons "
                  f"({self.horizon_tokens} tok)")
        if self.failed_by_reason:
            by = ", ".join(f"{k}:{v}"
                           for k, v in sorted(self.failed_by_reason.items()))
            s += f", {self.failed_requests} failed ({by})"
        return s


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,)
    max_new_tokens: int
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # filled by the engine: submit wall-clock (queue-wait/TTFT baseline),
    # the decode-step indices bounding the slot residency, and the
    # per-request latency record (0 <= queue <= ttft <= done_t - submit_t)
    submit_t: float = 0.0
    admit_step: int = -1
    done_step: int = -1
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0
    done_t: float = 0.0
    # priority class (validated at intake; this slice admits in FIFO
    # order), lifecycle status ("queued" -> "running" -> "done" |
    # "failed") and the terminal error code + message of a failed request
    priority: str = "batch"
    status: str = "queued"
    error: Optional[str] = None
    error_detail: Optional[str] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    tok: int = 0                 # last generated token (next decode input)
    pos: int = 0                 # host mirror of cache["length"][slot]
    pages: List[int] = dataclasses.field(default_factory=list)
    # chunked-prefill state: an admission is placed at once and then
    # prefilled chunk by chunk between decode steps
    prefilling: bool = False
    fill_pos: int = 0            # prompt positions already prefilled
    chunk_walls: List[float] = dataclasses.field(default_factory=list)
    # prefill_kernel-axis state: the backend this admission's chunks run,
    # and in auto mode the bucket its chunk walls feed
    kernel: str = "gather"
    kernel_bucket: Optional[Tuple] = None

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousBatchingEngine:
    """Token-level continuous batching over a fixed pool of decode slots.

    Engine iteration (:meth:`step`):

    1. **admit** — while a slot is free and the queue is non-empty, the
       oldest request is placed: pages covering its prompt are allocated
       and its block-table row installed; the slot starts prefilling;
    2. **prefill chunks** — at most ``chunks_per_step`` chunks run,
       round-robin over prefilling slots; each reads every earlier
       position through the slot's block table and writes its own K/V
       into the slot's pages.  The final chunk yields the first
       generated token (TTFT) and turns the slot to decoding;
    3. **decode** — one call advances every decoding slot by one token, or
       by up to H in a fused horizon (free and prefilling slots decode
       garbage that is discarded);
    4. **retire** — a request hitting EOS or ``max_new_tokens`` completes
       and frees its slot and pages at once.

    ``prefill_chunk`` is the chunk size in tokens, or ``"whole"`` for one
    chunk per prompt.  ``decode_horizon`` is a step count >= 1, or
    ``"auto"`` for the measured axis over 1 and ``horizon_choices``.
    ``device`` defaults to ``"cuda"`` and must hold ``params``; ``"cpu"``
    runs the kernels' plain versions.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 max_len: int = 256, vpe: Optional[VPE] = None,
                 occupancy_levels: int = 4, min_prompt_pad: int = 16,
                 block_size: int = 16, kv_layout: str = "paged",
                 prefill_chunk: Any = "whole",
                 chunks_per_step: Optional[int] = None,
                 decode_horizon: Any = 1,
                 horizon_choices: Tuple[int, ...] = (4, 16),
                 decode_impl: str = "auto", prefill_kernel: str = "auto",
                 prefix_blocks: int = 0, spec_draft: Any = "off",
                 page_budget: Optional[int] = None, swap: bool = False,
                 fault_plan: Any = None, max_queue_depth: Optional[int] = None,
                 mesh_shape: Tuple[int, int] = (1, 1),
                 device: DeviceLike = "cuda") -> None:
        if not model_lib.supports_slot_serving(cfg):
            raise ValueError(f"family {cfg.family!r} has no slot-serving path")
        if kv_layout == "contiguous":
            raise not_ported("kv_layout='contiguous'", "contiguous")
        if kv_layout == "auto":
            raise not_ported("kv_layout='auto'", "auto_layout")
        if kv_layout != "paged":
            raise ValueError(f"kv_layout must be 'paged', got {kv_layout!r}")
        if prefix_blocks:
            raise not_ported("prefix_blocks > 0", "prefix_cache")
        if spec_draft != "off":
            raise not_ported(f"spec_draft={spec_draft!r}", "speculation")
        if page_budget is not None or swap:
            raise not_ported("page_budget / swap", "preemption")
        if fault_plan is not None or max_queue_depth is not None:
            raise not_ported("fault_plan / max_queue_depth", "faults")
        if tuple(mesh_shape) != (1, 1):
            raise not_ported(f"mesh_shape={tuple(mesh_shape)}", "mesh")
        if prefill_chunk == "auto":
            raise not_ported("prefill_chunk='auto'", "chunk_axis")
        if isinstance(prefill_chunk, str):
            if prefill_chunk != "whole":
                raise ValueError("prefill_chunk must be a token count or 'whole'")
        elif int(prefill_chunk) < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = whole)")
        if chunks_per_step is not None and chunks_per_step < 1:
            raise ValueError("chunks_per_step must be >= 1 (or None = adaptive)")
        if isinstance(decode_horizon, str):
            if decode_horizon != "auto":
                raise ValueError(
                    "decode_horizon must be a step count >= 1 or 'auto'")
        elif int(decode_horizon) < 1:
            raise ValueError("decode_horizon must be >= 1")
        if any(int(h) < 2 for h in horizon_choices):
            raise ValueError("horizon_choices must all be >= 2 "
                             "(1 is always the incumbent)")
        if decode_impl != "auto" and decode_impl not in SERVE_AXES["serve_decode_impl"]:
            raise ValueError(f"decode_impl must be 'auto' or one of "
                             f"{SERVE_AXES['serve_decode_impl']}, got {decode_impl!r}")
        if prefill_kernel != "auto" and prefill_kernel not in SERVE_AXES["prefill_kernel"]:
            raise ValueError(f"prefill_kernel must be 'auto' or one of "
                             f"{SERVE_AXES['prefill_kernel']}, got {prefill_kernel!r}")
        if max_len % block_size:
            raise ValueError(f"max_len ({max_len}) must be a multiple of "
                             f"block_size ({block_size})")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.num_slots = slots
        self.max_len = max_len
        self.vpe = vpe
        self.occupancy_levels = occupancy_levels
        self.min_prompt_pad = min_prompt_pad
        self.block_size = block_size
        self.prefill_chunk = 0 if prefill_chunk == "whole" else int(prefill_chunk)
        self.chunks_per_step = chunks_per_step
        self.decode_horizon = (decode_horizon if decode_horizon == "auto"
                               else int(decode_horizon))
        self.horizon_choices = tuple(int(h) for h in horizon_choices)
        self.decode_impl = decode_impl
        self.prefill_kernel = prefill_kernel
        self.stats = ServeStats()
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.slots = [_Slot() for _ in range(slots)]
        self._chunk_rr = 0           # round-robin cursor over prefilling slots
        self._masks_dirty = True
        self._axis = "serve_decode_impl"
        if vpe is not None and not vpe.registry.has_op(self._axis):
            # a pinned decode_impl registers the axis as a SYSTEM op:
            # samples are recorded under the name that ran, never trialed
            vpe.registry.register_op(self._axis, system=(decode_impl != "auto"))
            for i, name in enumerate(SERVE_AXES[self._axis]):
                vpe.registry.register_variant(
                    self._axis, name, fn=(lambda name=name: name), default=(i == 0))
        if vpe is not None and prefill_kernel == "auto" \
                and not vpe.registry.has_op("prefill_kernel"):
            vpe.registry.register_op("prefill_kernel")
            for i, name in enumerate(SERVE_AXES["prefill_kernel"]):
                vpe.registry.register_variant(
                    "prefill_kernel", name, fn=(lambda name=name: name),
                    default=(i == 0))
        if vpe is not None and self.decode_horizon == "auto" \
                and not vpe.registry.has_op("decode_horizon"):
            # "1" (the single step) is the incumbent; the fused horizons
            # are the candidates, trialed per queue-depth x occupancy
            # bucket and fed from per-token walls
            vpe.registry.register_op("decode_horizon")
            names = ["1"] + [str(h) for h in self.horizon_choices]
            for i, name in enumerate(names):
                vpe.registry.register_variant(
                    "decode_horizon", name, fn=(lambda name=name: name),
                    default=(i == 0))
        # -- KV storage: the worst case of every slot holding max_len
        # positions plus one partial page each, so placement and decode
        # growth never run out of pages
        self.nb_max = max_len // block_size
        self.pages = PagePool(slots * self.nb_max + slots)
        self.page_pool = model_lib.init_page_pool(cfg, self.pages.num_pages,
                                                  block_size, self.device)
        self.cache = model_lib.init_paged_cache(cfg, slots, max_len, block_size,
                                                self.pages.trash_id, self.device)
        # device-side decode inputs, rows INPUT_ROWS (tok, live, eos,
        # budget): rewritten in place from the host slot mirrors only
        # after an admission / prefill completion / retire (and the budget
        # before a fused call); a steady decode call feeds its own final
        # tokens back into ``tok`` on the device.  These, the cache and the
        # pool are never rebound: the decode graphs replay over them.
        self._inputs = torch.zeros((len(INPUT_ROWS), slots), dtype=torch.int32,
                                   device=self.device)
        self.graphs = DecodeGraphs(cfg, params, self.page_pool, self.cache,
                                   self._inputs)
        if self.device.type == "cuda":
            # build and load the kernels now, and launch each once: the
            # port's capability check, which raises instead of degrading
            from repro_torch.kernels.paged_attention import prepare
            prepare(self.page_pool["k"].dtype, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim, block_size, self.device)

    # -- request intake ----------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue a request, or terminally fail one the engine can never
        serve (``status="failed"``, ``error="intake"``) — a bad request
        must not throw at a caller batching thousands."""
        req.submit_t = time.perf_counter()
        err = _intake_error(req, self.max_len)
        if err is not None:
            self._fail_request(req, "intake", err)
            return
        req.status = "queued"
        self.queue.append(req)

    def _fail_request(self, req: Request, reason: str, detail: str) -> None:
        req.error = reason
        req.error_detail = detail
        req.status = "failed"
        req.done = True
        req.done_t = time.perf_counter()
        req.queue_wait_s = req.done_t - req.submit_t
        self.stats.rejected += 1
        self.stats.failed_by_reason[reason] = \
            self.stats.failed_by_reason.get(reason, 0) + 1
        self.completed.append(req)

    @property
    def num_active(self) -> int:
        """Occupied slots — decoding AND mid-prefill (run() drains both)."""
        return sum(1 for s in self.slots if not s.free)

    @property
    def num_decoding(self) -> int:
        """Slots past their prefill: the decode step's real batch."""
        return sum(1 for s in self.slots
                   if s.req is not None and not s.prefilling)

    def check_kv(self) -> None:
        """Page audit: pool refcounts must be exactly the live block
        tables' pages.  Raises AssertionError on a leak or a dangling
        reference."""
        owners: Dict[int, int] = {}
        for s in self.slots:
            for pid in s.pages:
                owners[pid] = owners.get(pid, 0) + 1
        self.pages.check(owners)

    # -- admission ---------------------------------------------------------
    def _pop_next(self) -> Request:
        """Plain FIFO (priority-aware scheduling comes with item 8(f))."""
        return self.queue.pop(0)

    def _admit(self) -> None:
        while self.queue:
            i = next((j for j, s in enumerate(self.slots) if s.free), None)
            if i is None:
                return
            req = self._pop_next()
            now = time.perf_counter()
            req.admit_step = self.stats.decode_steps
            req.queue_wait_s = now - req.submit_t
            self.stats.queue_wait_s.append(req.queue_wait_s)
            req.status = "running"
            self._place_paged(i, req, occ=self.num_active)

    def _bt_row(self, pages: List[int]) -> np.ndarray:
        """A slot's full (nb_max,) block-table row, trash-padded past its
        allocated pages."""
        row = np.full((self.nb_max,), self.pages.trash_id, np.int32)
        row[:len(pages)] = pages
        return row

    def _alloc_page(self) -> int:
        pid = self.pages.alloc()
        if pid is None:     # the pool is sized for the worst case
            raise RuntimeError("page pool exhausted; preemption is ROADMAP "
                               f"queue 1, item {LATER['preemption']}")
        return pid

    def _place_paged(self, i: int, req: Request, occ: int) -> None:
        """Placement only: allocate pages covering the prompt and install
        the slot's block-table row (length stays 0 until the prefill
        completes — the live mask keeps the slot out of decode meanwhile).
        The prompt's compute runs as chunks (:meth:`_run_prefill_chunks`)."""
        slot = self.slots[i]
        S = len(req.prompt)
        t0 = time.perf_counter()
        slot.pages = [self._alloc_page() for _ in range(-(-S // self.block_size))]
        self.cache["bt"][i] = torch.from_numpy(self._bt_row(slot.pages)).to(self.device)
        self.cache["length"][i] = 0
        fence(self.device)
        dt = time.perf_counter() - t0
        self.stats.kv_place_s.append(dt)
        self.stats.prefill_s += dt
        self.stats.paged_admits += 1
        slot.req = req
        slot.prefilling = True
        slot.fill_pos = 0
        slot.chunk_walls = []
        slot.kernel, slot.kernel_bucket = self._select_prefill_kernel(S, occ)
        self._masks_dirty = True

    def _select_prefill_kernel(self, S: int, occ: int):
        """This admission's chunk-attention backend and, in auto mode with
        a VPE, its ``prefill_kernel`` bucket (else None)."""
        if self.prefill_kernel != "auto":
            return self.prefill_kernel, None
        if self.vpe is None:
            return SERVE_AXES["prefill_kernel"][0], None
        bucket = prefill_chunk_bucket(S, occ, self.num_slots,
                                      levels=self.occupancy_levels)
        return self.vpe.controller.select("prefill_kernel", bucket), bucket

    # -- chunked prefill ---------------------------------------------------
    def _effective_chunk_budget(self) -> int:
        """Chunks allowed this engine step: the explicit ``chunks_per_step``,
        else 1 while decoding slots wait (their stall is what the budget
        bounds) and one per prefilling slot when nothing decodes."""
        if self.chunks_per_step is not None:
            return self.chunks_per_step
        if self.num_decoding > 0:
            return 1
        return max(1, sum(1 for s in self.slots if s.prefilling))

    def _run_prefill_chunks(self) -> bool:
        ran = False
        budget = self._effective_chunk_budget()
        for _ in range(budget):
            order = [(self._chunk_rr + k) % self.num_slots
                     for k in range(self.num_slots)]
            i = next((j for j in order if self.slots[j].prefilling), None)
            if i is None:
                break
            self._chunk_rr = (i + 1) % self.num_slots
            self._run_one_chunk(i)
            ran = True
        if ran:
            self.stats.chunk_budget_hist[budget] = \
                self.stats.chunk_budget_hist.get(budget, 0) + 1
        return ran

    def _run_one_chunk(self, i: int) -> None:
        """One chunk of slot ``i``'s prompt; the final chunk yields the
        first generated token."""
        slot = self.slots[i]
        prompt = slot.req.prompt
        S = len(prompt)
        base = slot.fill_pos
        chunk = self.prefill_chunk
        clen = (S - base) if not chunk else min(chunk, S - base)
        pad = min(pad_to_bucket(clen, minimum=self.min_prompt_pad), self.max_len)
        toks = np.zeros((1, pad), np.int32)
        toks[0, :clen] = prompt[base:base + clen]
        t0 = time.perf_counter()
        row = torch.from_numpy(self._bt_row(slot.pages)).to(self.device)
        _, logits = model_lib.prefill_chunk_paged(
            self.cfg, self.params, self.page_pool, row,
            torch.from_numpy(toks).to(self.device), base, clen,
            kernel=slot.kernel)
        # fence: an unfinished chunk would leak its device time into the
        # next decode step's VPE sample (and undercount this admission's)
        fence(self.device)
        dt = time.perf_counter() - t0
        slot.chunk_walls.append(dt)
        self.stats.prefill_s += dt
        self.stats.prefill_chunks += 1
        slot.fill_pos = base + clen
        if slot.fill_pos >= S:
            self._finish_prefill(i, logits)

    def _finish_prefill(self, i: int, logits: torch.Tensor) -> None:
        """Last chunk done: first token out, device length installed, the
        summed chunk walls fed to the ``prefill_kernel`` controller."""
        slot = self.slots[i]
        req = slot.req
        first = int(torch.argmax(logits[0]))
        self.cache["length"][i] = len(req.prompt)
        if self.vpe is not None and slot.kernel_bucket is not None:
            self.vpe.profiler.record("prefill_kernel", slot.kernel,
                                     slot.kernel_bucket, sum(slot.chunk_walls))
            self.vpe.controller.on_sample("prefill_kernel", slot.kernel_bucket,
                                          slot.kernel)
        slot.kernel_bucket = None
        self._enter_decode(i, first)
        self._retire_if_done(i)

    def _enter_decode(self, i: int, first: int) -> None:
        """Emit the first generated token (TTFT) and start decoding."""
        slot = self.slots[i]
        req = slot.req
        req.ttft_s = time.perf_counter() - req.submit_t
        self.stats.ttft_s.append(req.ttft_s)
        req.out.append(first)
        self.stats.tokens_out += 1
        self.stats.prefill_tokens += 1
        slot.prefilling = False
        slot.tok = first
        slot.pos = len(req.prompt)
        self._masks_dirty = True

    def _retire_if_done(self, i: int) -> None:
        slot = self.slots[i]
        req = slot.req
        if req is None:
            return
        hit_eos = req.eos_id is not None and req.out and req.out[-1] == req.eos_id
        if len(req.out) >= req.max_new_tokens or hit_eos:
            req.done = True
            req.status = "done"
            req.done_step = self.stats.decode_steps
            req.done_t = time.perf_counter()
            for pid in slot.pages:
                self.pages.unref(pid)
            slot.pages = []
            self.completed.append(req)
            slot.req = None   # freed mid-decode; refilled next admission
            self._masks_dirty = True

    # -- decode -------------------------------------------------------------
    def _grow_block_tables(self, span: int, remaining: Dict[int, int]) -> None:
        """Before a decode call: reserve, for every decoding slot, the
        pages covering its write range ``[pos, pos + min(span,
        remaining))`` — mid-horizon there is no host to allocate a page —
        and install every splice in ONE scatter.  At ``span=1`` a page
        comes exactly when the next token starts a fresh block."""
        splices: List[Tuple[int, int, int]] = []
        for i, slot in enumerate(self.slots):
            if slot.free or slot.prefilling:
                continue
            upto = slot.pos + min(span, remaining[i])
            last_col = (upto - 1) // self.block_size
            assert last_col < self.nb_max, (last_col, self.nb_max)
            for col in range(len(slot.pages), last_col + 1):
                pid = self._alloc_page()
                slot.pages.append(pid)
                splices.append((i, col, pid))
        if splices:
            idx = torch.tensor(splices, dtype=torch.int64).T.to(self.device)
            self.cache["bt"][idx[0], idx[1]] = idx[2].to(torch.int32)

    def _rollback_reserved(self, i: int) -> None:
        """Return a slot's reserved-but-unwritten horizon pages to the
        pool (a stop froze the slot before it reached them): the pages
        covering ``[0, pos)`` stay, every page past them goes back."""
        slot = self.slots[i]
        keep = -(-slot.pos // self.block_size)      # ceil
        while len(slot.pages) > keep:
            self.pages.unref(slot.pages.pop())
            self.stats.reserved_pages_rolled_back += 1

    def _refresh_device_masks(self) -> None:
        """Rewrite the tok, live and eos rows of the device inputs from the
        host slot mirrors, in place and in one copy — only after an
        admission, prefill completion or retire dirtied them."""
        if not self._masks_dirty:
            return
        rows = np.array([
            [s.tok for s in self.slots],
            [0 if (s.free or s.prefilling) else 1 for s in self.slots],
            [-1 if (s.req is None or s.req.eos_id is None) else s.req.eos_id
             for s in self.slots]], np.int32)
        self._inputs[:3].copy_(torch.from_numpy(rows))
        self._masks_dirty = False

    def _select_decode_impl(self, bucket: Tuple) -> str:
        if self.decode_impl != "auto":
            return self.decode_impl
        if self.vpe is not None:
            # per-call selection, in-flight trials included — the eager
            # analogue of the paper's patched function pointer
            return self.vpe.controller.select(self._axis, bucket)
        return SERVE_AXES[self._axis][0]

    def _select_horizon(self, n_active: int
                        ) -> Tuple[int, Optional[Tuple], Optional[str]]:
        """This step's decode horizon and, on the measured axis, its VPE
        bucket and variant name.  The bucket is keyed by the queue depth
        left after this step's admissions — the requests a fused horizon
        would delay — × occupancy."""
        if self.decode_horizon != "auto":
            return int(self.decode_horizon), None, None
        if self.vpe is None:
            return 1, None, None
        bucket = decode_horizon_bucket(len(self.queue), n_active,
                                       self.num_slots,
                                       levels=self.occupancy_levels)
        name = self.vpe.controller.select("decode_horizon", bucket)
        return int(name), bucket, name

    def _commit(self, i: int, new_toks: List[int]) -> None:
        """Append a decoding slot's new tokens to its request and mirrors."""
        slot = self.slots[i]
        slot.req.out.extend(new_toks)
        slot.tok = new_toks[-1]
        slot.pos += len(new_toks)
        self.stats.tokens_out += len(new_toks)

    def _decode(self, H: int, hbucket, hname,
                remaining: Dict[int, int], t_h: float) -> None:
        """One decode call of H steps (H = 1 is a single step): reserve
        every page the call can write (one block-table scatter), run the H
        steps on the device, fence once on the (slots, H) token block,
        commit each slot's valid tokens, roll its unused reserved pages
        back and retire it if it stopped."""
        self._grow_block_tables(span=H, remaining=remaining)
        self._refresh_device_masks()
        budget = np.zeros((self.num_slots,), np.int32)
        for i, rem in remaining.items():
            budget[i] = rem
        self.graphs.budget.copy_(torch.from_numpy(budget))
        bucket = occupancy_bucket(len(remaining), self.num_slots,
                                  levels=self.occupancy_levels)
        impl = self._select_decode_impl(bucket)
        t0 = time.perf_counter()
        # greedy argmax on the device; only the (slots, H) token block and
        # valid mask cross to the host, and that copy is the call's fence
        toks, emits, captured = self.graphs.run(impl, H)
        dt = time.perf_counter() - t0
        self.stats.decode_s += dt
        self.stats.decode_steps += H
        self.stats.horizon_hist[H] = self.stats.horizon_hist.get(H, 0) + 1
        self.stats.tainted_steps += captured
        valid_total = int(emits.sum())
        if H > 1:
            self.stats.horizon_calls += 1
            self.stats.horizon_tokens += valid_total
        if self.vpe is not None and not captured:
            # the decode-attention axis keeps per-STEP units
            self.vpe.profiler.record(self._axis, impl, bucket, dt / H)
            self.vpe.controller.on_sample(self._axis, bucket, impl)
        for i in remaining:
            # a slot stops at most once, so its valid tokens are a prefix
            e = int(emits[i].sum())
            self._commit(i, [int(t) for t in toks[i, :e]])
            self._rollback_reserved(i)
            self._retire_if_done(i)
        if self.vpe is not None and hbucket is not None and not captured \
                and valid_total:
            # per-TOKEN wall of the whole span (reservation, call, fence,
            # commit — the host work a horizon amortizes); frozen steps
            # emit nothing, so an over-long horizon pays for itself here
            self.vpe.profiler.record("decode_horizon", hname, hbucket,
                                     (time.perf_counter() - t_h) / valid_total)
            self.vpe.controller.on_sample("decode_horizon", hbucket, hname)

    def step(self) -> bool:
        """One engine iteration; returns False when fully idle.

        Admission and at most ``chunks_per_step`` prefill chunks run
        first, then ONE decode call advances the decoding slots — the wall
        between two decode calls is bounded by the chunk budget
        (``stats.decode_stall_s``) and the horizon."""
        had_decoders = self.num_decoding > 0
        admits_before = len(self.stats.queue_wait_s)
        t_p = time.perf_counter()
        self._admit()
        ran_chunk = self._run_prefill_chunks()
        prefill_work = ran_chunk or len(self.stats.queue_wait_s) != admits_before
        n_active = self.num_decoding
        if n_active == 0:
            return prefill_work
        if had_decoders and prefill_work:
            self.stats.decode_stall_s.append(time.perf_counter() - t_p)
        # the horizon axis's timed span starts here: it holds the host work
        # a fused horizon amortizes, not only the fenced device wall
        t_h = time.perf_counter()
        H, hbucket, hname = self._select_horizon(n_active)
        # tokens each decoding slot may still emit: the call's budget, and
        # the horizon's clamp onto the DECLARED set ({1, H} pinned, {1} +
        # horizon_choices auto) — an arbitrary clamped length would capture
        # a new graph mid-serve
        remaining = {i: s.req.max_new_tokens - len(s.req.out)
                     for i, s in enumerate(self.slots)
                     if s.req is not None and not s.prefilling}
        cap = pad_to_bucket(max(remaining.values()), minimum=1)
        allowed = [1] + [c for c in
                         (self.horizon_choices
                          if self.decode_horizon == "auto" else (H,))
                         if c <= H]
        H = max(c for c in allowed if c <= cap)
        self._decode(H, hbucket, hname, remaining, t_h)
        return True

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drain queue + slots; returns completed requests."""
        steps = 0
        while self.queue or self.num_active > 0:
            if not self.step():
                break
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.completed
