"""Serving runtime: the wave baseline and token-level continuous batching.

The counterpart of ``repro.runtime.serve_loop``.  ``ServeLoop.generate`` is
the simple batch API (one prefill, N decode steps, every row in lockstep)
and :class:`WaveScheduler` the baseline batcher on it: a wave of requests
runs to completion before the next starts.

:class:`ContinuousBatchingEngine` serves greedy decoding of a dense model
over a fixed pool of decode slots; a finished request frees its slot
mid-decode and the next queued request enters it.  Each slot holds its KV
in one of two layouts (``kv_layout``):

* ``"contiguous"`` — a region of the per-slot cache.  Admission prefills
  the whole prompt at once and copies its K/V in; a warm prefix is copied
  in from cached pages and only the suffix is prefilled.
* ``"paged"`` — a block table of page ids into the unified page pool that
  the prefix tree shares.  Admission only *places* the request: matched
  pages are aliased (zero-copy, copy-on-write on a partially matched tail
  block), pages covering the rest are allocated, the block-table row is
  installed; the prompt is then prefilled in chunks, between decode
  steps, that read every earlier position in place through the table.
  A cold prompt's full blocks are adopted into the tree zero-copy.
* ``"auto"`` — both structures, and the layout of each admission is a
  measured VPE decision; the decode step computes both reads and selects
  per slot.

With ``prefix_blocks > 0`` a radix-tree shared-prefix cache
(:class:`~repro_torch.runtime.prefix_cache.PrefixCache`) sits in front of
admission: the longest cached prefix of the prompt is matched and pinned
for the request's residency, and admission is prefix-aware (the best match
in the queue's front window goes first; a request is jumped at most
``max_skip`` times).  A decode call advances every decoding slot by one
token, or by up to H tokens in one fused horizon (``decode_horizon``).

Measured implementation axes (VPE, the paper's profile-guided dispatch):

* ``serve_decode_impl`` — ``grouped``/``flat`` attend over the contiguous
  cache or gathered pages, ``cuda`` scores pages in place through the
  decode kernel (on a contiguous cache it is ``grouped``); keyed by slot
  occupancy and fed from the wall of each decode call;
* ``prefix_reuse`` — reuse the cached prefix or recompute it; keyed by
  matched length and fed from the admission's TTFT contribution;
* ``kv_layout`` (``auto`` only) — keyed by matched length × occupancy and
  fed at retire from the admission wall plus the request's share of the
  decode calls;
* ``prefill_kernel`` — ``gather`` or the ``cuda`` multi-query kernel for
  chunked prefill; keyed by prompt length × occupancy;
* ``prefill_chunk`` (``prefill_chunk="auto"``) — ``whole`` or a chunk size
  from ``chunk_choices``; keyed by prompt length × occupancy and fed from
  the summed chunk walls of an admission;
* ``decode_horizon`` — ``1`` or a fused horizon from ``horizon_choices``;
  keyed by queue depth × occupancy and fed from per-token walls.

With ``slo_weight`` > 0 the horizon and chunk axes optimize a two-term
objective: each sample is charged ``wall × (1 + slo_weight × pressure)``,
the pressure being the class-weighted count of queued requests, and their
keys carry the queue's composition (:func:`slo_pressure_bucket`).

**Page pressure.**  ``page_budget`` runs the paged pool below its worst
case.  A page then comes from the free list, else from evicting a cached
prefix, else from preempting a victim slot (prefilling victims of a lower
class first; decode growth also takes equal-class prefills and
lower-class decoders, and preempts the grower itself when nothing else
is left).  A placement that cannot finish rolls back every reference it
took and requeues its request at the head of its class.  A preempted
request resumes exactly: greedy decode is deterministic, so it re-prefills
:meth:`Request.effective_prompt` (its prompt and the tokens it emitted),
or, with ``swap=True``, its filled K/V comes back from pinned host memory
into fresh pages and the prefill resumes where it stopped.  Requests carry
a priority class: ``interactive`` goes before ``batch`` in the admission
window and is never preempted by it.

**Speculative decoding.**  With ``spec_draft`` (a span S >= 2, or
``"auto"``: the measured ``spec_draft`` axis over ``off`` and
``spec_choices``, keyed by queue depth x occupancy x the engine's measured
acceptance level), an n-gram table over the streams the engine has served
(:class:`~repro_torch.runtime.spec_decode.NGramProposer`) drafts S-1
tokens a decoding slot, and ONE verify pass scores all S positions and
commits the longest verified prefix plus one correction: the tokens are
the greedy stream's, whatever the drafts.  A speculating step replaces the
decode call; the rejected tail's reserved pages go back to the pool.  A
contiguous engine and ``decode_horizon=1`` resolve ``spec_draft`` to
``"off"``.

**Faults and deadlines.**  A seeded
:class:`~repro_torch.runtime.serve_faults.FaultPlan` injects device errors,
poisoned logits or fence stalls at the engine's fenced spans (``decode``,
``fused``, ``spec``, ``prefill``, ``page_alloc``), and the engine recovers
through a ladder that quarantines the variant before the request: a
device fault or a stall demotes its rung — ``decode_cuda`` (the decode
kernel; the axis's ``grouped`` variant runs), ``prefill_cuda`` (``gather``
runs), ``spec`` (off), ``horizon`` (single steps) — for ``probation_steps``
clean decode spans, after which the rung is re-promoted; poisoned tokens
quarantine only their slot (preempted without swap and resumed exactly
from its committed tokens); a fault with no rung left to blame charges the
touched requests, and a request at ``max_request_faults`` fails with the
reason code ``device_fault`` or ``numeric_fault``.  The ladder acts only
on :class:`~repro_torch.runtime.fault.SimulatedFault` from the plan and on
the watchdog's :class:`~repro_torch.distributed.straggler.StragglerTimeout`
(``watchdog``): a real CUDA error propagates, since a context after an
illegal access cannot be recovered.  ``Request.deadline_s`` sheds a
request past its deadline (queued or resident, reason ``deadline``) and
``max_queue_depth`` refuses submissions beyond that depth (``capacity``).

A pinned ``"cuda"`` runs the kernel — or raises; there is no capability
fallback (a demoted rung runs a registered variant that needs no kernel,
never a kernel module's plain version on the card).  On a CUDA device the
kernels the layout runs are built and launched once in the constructor, so
no timed step pays for ``nvcc`` or a first load, and every decode call and
every verify call replays a CUDA graph captured at the first call of its
(layout, decode-attention variant, H) or (layout, S)
(:mod:`repro_torch.runtime.decode_graphs`, the counterpart of the
reference's jit cache).  A call that captured is the counterpart of a call
that compiled: it is counted in ``stats.tainted_steps`` and feeds no axis.

**Replicas.**  :func:`make_serve_engine` builds the engine for a ``(dp,
mp)`` mesh: ``(1, 1)`` is the single engine, whose dispatch keys carry no
mesh segment; ``dp > 1`` is an :class:`EngineReplicaGroup`, dp engines on
the torch devices of ``mesh_devices`` behind one shared admission queue,
with replica quarantine, migration and canary re-admission above the
engine's own ladder.  One device may be named more than once (two replicas
on one card).  Every replica keys its axes with the group's full mesh
(:func:`~repro_torch.core.shard_bucket`), so a shared VPE learns one
policy per mesh.

**Head sharding.**  ``mp > 1`` runs one process a shard
(:mod:`repro_torch.distributed.group`): every rank builds the same engine
with a :class:`~repro_torch.distributed.group.ShardGroup`, is handed the
same submissions, and serves them over its slice of the heads, the FFN
hidden dim and the experts (:func:`~repro_torch.distributed.sharding.
shard_params`), one all-reduce after each down-projection completing the
sum.  The same code runs on every rank, so every rank must take the same
decisions: rank 0 takes each one that reads a clock or a measured time —
the VPE's selections, the deadline reads, the watchdog's verdicts — and
the others take its value (:meth:`ShardGroup.agree`), and after every
prefill and decode call rank 0's tokens are the ones committed
(``stats.shard_token_mismatch`` counts the calls where a rank's own
differed; the all-reduce makes the logits equal, so it stays 0).  A
sharded rank replays no CUDA graph: its collectives go through ``gloo``
where ranks share a card, and those cannot be captured.  Every rank's
pool holds the KV heads its query heads read, so the paged kernels run
on a shard at its own head counts, whatever ``Hkv % mp`` is (the
reference, one GSPMD program, replicates the pool and runs the gather
path when the KV heads do not split evenly).  Only rank 0's ``stats``
and VPE are the engine's report.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import DeviceLike, fence, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (VPE, decode_horizon_bucket, kv_layout_bucket,
                              occupancy_bucket, pad_to_bucket,
                              prefill_chunk_bucket, prefix_len_bucket,
                              shard_bucket, slo_pressure_bucket,
                              spec_accept_bucket)
from repro_torch.core.spans import span
from repro_torch.distributed.group import ShardGroup, ShardScope, shard_scope
from repro_torch.distributed.sharding import shard_params, shard_plan
from repro_torch.distributed.straggler import StepWatchdog, StragglerTimeout
from repro_torch.models import kvcache
from repro_torch.models import model as model_lib
from repro_torch.runtime.decode_graphs import INPUT_ROWS, DecodeGraphs
from repro_torch.runtime.page_pool import PagePool
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.runtime.serve_faults import FaultPlan, SimulatedFault
from repro_torch.runtime.spec_decode import NGramProposer

# serve-engine implementation axes (first = default)
SERVE_AXES: Dict[str, List[str]] = {
    "serve_decode_impl": list(kvcache.DECODE_ATTN_VARIANTS),
    "prefix_reuse": ["reuse", "recompute"],
    "kv_layout": ["contiguous", "paged"],
    "prefill_kernel": ["gather", "cuda"],
}

KV_LAYOUTS = ("contiguous", "paged", "auto")

# request priority classes, best first: rank 0 (interactive) is never
# preempted by rank 1 (batch) and goes first in the admission window; the
# SLO pressure term weighs a queued interactive request 1.0, a batch one 0.1
PRIORITY_CLASSES = ("interactive", "batch")
PRIORITY_RANK: Dict[str, int] = {c: i for i, c in enumerate(PRIORITY_CLASSES)}
SLO_CLASS_WEIGHT: Dict[str, float] = {"interactive": 1.0, "batch": 0.1}

# terminal failure reason codes (``Request.error``; the message is in
# ``Request.error_detail``); ``replica_lost`` is the replica group's: a
# request whose fault budget ran out migrating off dying replicas or on
# lost dispatches
FAIL_REASONS = ("intake", "deadline", "capacity", "device_fault",
                "numeric_fault", "replica_lost")

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


def _request_digest(req: "Request") -> str:
    """What every rank of a sharded engine must agree on about a request."""
    h = hashlib.sha256(repr((req.rid, int(req.max_new_tokens), req.priority,
                             req.deadline_s, req.eos_id)).encode())
    h.update(np.asarray(req.prompt).astype(np.int64).tobytes())
    return h.hexdigest()


def _agree_request(group: ShardGroup, req: "Request", now: float) -> float:
    """Check that every rank was handed the same ``req`` (``ValueError`` on
    every rank when one was not) and return rank 0's ``now``, its submit
    time on every rank: the deadlines are read against rank 0's clock."""
    seen = group.gather((_request_digest(req), now))
    if any(digest != seen[0][0] for digest, _ in seen):
        raise ValueError(
            f"request {req.rid} differs across the {group.world} shard ranks: "
            f"every rank must be handed the same submissions")
    return seen[0][1]


class _PagePressure(RuntimeError):
    """The free list, prefix-tree eviction and preemption could not supply
    a page.  Internal control flow only: placement rolls back and requeues
    on it, decode growth preempts the growing slot; it never leaves the
    engine."""


@dataclasses.dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0
    prefill_tokens: int = 0          # tokens produced by prefill, not decode
    decode_steps: int = 0
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    queue_wait_s: List[float] = dataclasses.field(default_factory=list)
    # per first token: its request's wait for chunk turns while admitted
    # (``Request.prefill_wait_s``)
    prefill_wait_s: List[float] = dataclasses.field(default_factory=list)
    # shared-prefix cache (0 when the cache is off): lookups, admissions
    # that reused a cached prefix, prompt tokens served from cached pages
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_tokens_saved: int = 0
    # KV-placement wall per admission: contiguous, the copy of the prompt's
    # (or the cached prefix's) K/V into the slot region; paged, aliasing,
    # copy-on-write and the block-table install
    kv_place_s: List[float] = dataclasses.field(default_factory=list)
    paged_admits: int = 0
    cow_copies: int = 0              # partially matched tail blocks cloned
    placement_rollbacks: int = 0     # placements undone for want of pages
    sched_skips: int = 0             # queue entries jumped by prefix-aware
                                     # admission
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
    # decode and verify calls kept out of the VPE: those that captured
    # their CUDA graph, and those whose fence stalled
    tainted_steps: int = 0
    # speculative decoding: verify calls, drafts offered (the draft
    # positions a slot's budget could still commit) and accepted, and the
    # per-slot-call histogram {accepted drafts: occurrences}
    spec_calls: int = 0
    draft_tokens: int = 0
    accepted_tokens: int = 0
    accept_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    # faults survived: injected device faults, poisoned-logit events, fence
    # stalls (planned, or the watchdog's), ladder demotions by rung and the
    # re-promotions that ended a clean probation window
    device_faults: int = 0
    numeric_faults: int = 0
    watchdog_trips: int = 0
    demotions: Dict[str, int] = dataclasses.field(default_factory=dict)
    repromotions: int = 0
    # page pressure: slots preempted for pages (decode_preemptions counts
    # the decoding ones), host swaps and the pages they moved, and the
    # fenced wall of each swap-out and swap-in
    preemptions: int = 0
    decode_preemptions: int = 0
    swap_outs: int = 0
    swap_ins: int = 0
    swapped_pages: int = 0
    swap_out_s: List[float] = dataclasses.field(default_factory=list)
    swap_in_s: List[float] = dataclasses.field(default_factory=list)
    # the replica group's quarantine and canary lifecycle
    replica_quarantines: int = 0
    replica_readmissions: int = 0
    canary_probes: int = 0
    # head sharding: calls after which this rank's own tokens differed
    # from rank 0's (rank 0's were committed)
    shard_token_mismatch: int = 0

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
        """Terminally failed submissions, all reasons.  ``rejected`` is the
        never-admitted part of them, so ``submitted == len(queue_wait_s) +
        rejected`` once drained."""
        return sum(self.failed_by_reason.values())

    @property
    def prefix_hit_rate(self) -> float:
        return (self.prefix_hits / self.prefix_lookups
                if self.prefix_lookups else 0.0)

    def summary(self) -> str:
        s = (f"{self.tokens_out} tok, {self.total_tok_per_s:.1f} tok/s agg "
             f"({self.decode_tok_per_s:.1f} decode), "
             f"ttft {self.mean_ttft_s * 1e3:.1f}ms, "
             f"queue {self.mean_queue_wait_s * 1e3:.1f}ms")
        if self.prefix_lookups:
            s += (f", prefix-cache {self.prefix_hits}/{self.prefix_lookups} "
                  f"hits ({self.prefix_tokens_saved} tok saved)")
        if self.paged_admits:
            s += (f", paged {self.paged_admits} admits "
                  f"({self.cow_copies} cow)")
        if self.prefill_chunks:
            s += f", {self.prefill_chunks} prefill chunks"
        if self.horizon_calls:
            s += (f", {self.horizon_calls} fused horizons "
                  f"({self.horizon_tokens} tok)")
        if self.spec_calls:
            rate = (self.accepted_tokens / self.draft_tokens
                    if self.draft_tokens else 0.0)
            s += (f", {self.spec_calls} spec verifies "
                  f"({self.accepted_tokens}/{self.draft_tokens} drafts, "
                  f"{rate:.0%} accept)")
        if self.preemptions:
            s += (f", {self.preemptions} preemptions "
                  f"({self.decode_preemptions} decode)")
        if self.swap_outs:
            s += (f", {self.swap_outs}/{self.swap_ins} swaps out/in "
                  f"({self.swapped_pages} pages)")
        if self.failed_by_reason:
            by = ", ".join(f"{k}:{v}"
                           for k, v in sorted(self.failed_by_reason.items()))
            s += f", {self.failed_requests} failed ({by})"
        if self.device_faults or self.numeric_faults or self.watchdog_trips:
            s += (f", faults survived {self.device_faults} device / "
                  f"{self.numeric_faults} numeric / "
                  f"{self.watchdog_trips} stalls")
        if self.demotions:
            by = ", ".join(f"{k}:{v}"
                           for k, v in sorted(self.demotions.items()))
            s += (f", demotions {by} "
                  f"({self.repromotions} re-promoted)")
        if self.replica_quarantines:
            s += (f", {self.replica_quarantines} replica quarantines "
                  f"({self.replica_readmissions} re-admitted, "
                  f"{self.canary_probes} canaries)")
        if self.shard_token_mismatch:
            s += f", {self.shard_token_mismatch} shard token mismatches"
        return s


class ServeLoop:
    """Batch generation: one prefill of B prompts into a lockstep cache,
    then ``max_new_tokens`` greedy decode steps for all rows together."""

    def __init__(self, cfg: ModelConfig, params: Any, *, max_len: int = 256,
                 batch: int = 4, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"serve loop on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.batch = batch
        self.stats = ServeStats()

    def generate(self, batch_in: Dict[str, np.ndarray],
                 max_new_tokens: int) -> np.ndarray:
        """batch_in: {"tokens": (B, S)} (+ "frames" for encdec) -> (B,
        max_new_tokens) int32.  Every key goes to ``prefill`` as a tensor on
        the loop's device (tokens as int32)."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch_in.items()}
        batch["tokens"] = batch["tokens"].to(torch.int32)
        B = batch["tokens"].shape[0]
        cache = model_lib.init_cache(self.cfg, B, self.max_len, self.device)
        t0 = time.perf_counter()
        cache, logits = model_lib.prefill(self.cfg, self.params, batch, cache)
        fence(self.device)
        self.stats.prefill_s += time.perf_counter() - t0
        out = []
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        t0 = time.perf_counter()
        for _ in range(max_new_tokens):
            out.append(tok)
            cache, logits = model_lib.decode_step(self.cfg, self.params,
                                                  cache, tok)
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        new = torch.cat(out, dim=1).cpu().numpy()      # the fence
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.tokens_out += B * max_new_tokens
        return new


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
    # per-request latency record (0 <= queue <= ttft <= done_t - submit_t),
    # and the part of first admission -> first token in which the request
    # sat admitted while other slots' chunks and decode calls ran: that
    # wall less its placement and its own chunk walls (a contiguous
    # admission prefills at once: 0)
    submit_t: float = 0.0
    admit_step: int = -1
    done_step: int = -1
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0
    prefill_wait_s: float = 0.0
    done_t: float = 0.0
    # the prefix-cache pin held while resident, and the times a later
    # request was admitted ahead of this one (bounded by its class's
    # max_skip)
    cache_handle: Optional[Any] = None
    skips: int = 0
    # priority class (PRIORITY_CLASSES), lifecycle status ("queued" ->
    # "running" -> ["preempted" -> "running"]* -> "done" | "failed"), the
    # terminal error code + message of a failed request, the times it was
    # preempted for pages, while preempted with swap on the host copy of
    # its filled K/V (k, v, filled), and whether its TTFT is recorded
    # (once per request, across preemptions)
    priority: str = "batch"
    status: str = "queued"
    error: Optional[str] = None
    error_detail: Optional[str] = None
    preemptions: int = 0
    swap: Optional[Tuple] = None
    ttft_recorded: bool = False
    # wall-clock budget from submit: past ``submit_t + deadline_s`` the
    # request is shed (``deadline``) where the engine next looks at it —
    # the queue sweep, admission or a step boundary; None = no deadline
    deadline_s: Optional[float] = None
    # device and numeric faults charged to this request (a migration off
    # a quarantined replica too); at the engine's ``max_request_faults`` it
    # fails instead of retrying
    faults: int = 0
    # a replica group's canary probe: engine-internal, excluded from the
    # group's ``completed`` and never migrated off its replica
    canary: bool = False

    def effective_prompt(self) -> np.ndarray:
        """The tokens a (re-)admission must have in KV before decode goes
        on: the prompt and every token already emitted.  Greedy decode is
        deterministic, so a preempted request resumes exactly by
        prefilling this (the last emitted token's logits give the next)."""
        p = np.asarray(self.prompt, np.int32)
        if not self.out:
            return p
        return np.concatenate([p, np.asarray(self.out, np.int32)])


class WaveScheduler:
    """Wave batching over a fixed decode batch (the baseline).

    A wave of ``serve.batch`` requests runs to completion — left-padded to
    the longest prompt and decoded for the wave's longest
    ``max_new_tokens`` — before the next wave starts.  No mid-decode
    admission: this is what :class:`ContinuousBatchingEngine` is measured
    against."""

    def __init__(self, serve: ServeLoop) -> None:
        self.serve = serve
        self.queue: List[Request] = []
        self.completed: List[Request] = []

    def submit(self, req: Request) -> None:
        req.submit_t = time.perf_counter()
        self.queue.append(req)

    def run(self) -> List[Request]:
        B = self.serve.batch
        while self.queue:
            wave, self.queue = self.queue[:B], self.queue[B:]
            span = max(len(r.prompt) for r in wave)
            toks = np.zeros((len(wave), span), np.int32)
            for i, r in enumerate(wave):
                toks[i, -len(r.prompt):] = r.prompt  # left-pad
            new = self.serve.generate({"tokens": toks},
                                      max(r.max_new_tokens for r in wave))
            for i, r in enumerate(wave):
                r.out = [int(t) for t in new[i, :r.max_new_tokens]]
                r.done = True
                r.status = "done"
                self.completed.append(r)
        return self.completed


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    tok: int = 0                 # last generated token (next decode input)
    layout: str = "contiguous"   # KV layout this residency decodes through
    pos: int = 0                 # host mirror of cache["length"][slot]
    pages: List[int] = dataclasses.field(default_factory=list)
    # chunked-prefill state: a paged admission is placed at once and then
    # prefilled chunk by chunk between decode steps
    prefilling: bool = False
    fill_pos: int = 0            # prompt positions already prefilled
    chunk: int = 0               # chunk size this admission runs (0 = whole)
    chunk_walls: List[float] = dataclasses.field(default_factory=list)
    # each chunk's wall charged x (1 + slo_weight x queue pressure at the
    # chunk): what the chunk axes are fed (the walls when slo_weight = 0)
    chunk_costs: List[float] = dataclasses.field(default_factory=list)
    # prefill_chunk-axis state (prefill_chunk="auto")
    chunk_bucket: Optional[Tuple] = None
    chunk_variant: Optional[str] = None
    # prefill_kernel-axis state: the backend this admission's chunks run,
    # and in auto mode the bucket its chunk walls feed
    kernel: str = "gather"
    kernel_bucket: Optional[Tuple] = None
    place_wall: float = 0.0      # the paged placement span of this admission
    # the selected prefill_kernel name (the samples are recorded under it;
    # a demoted rung runs gather), and whether a stalled chunk fence
    # tainted this admission's samples
    kernel_variant: Optional[str] = None
    tainted: bool = False
    # prefix_reuse sample, fed when the prefill completes
    reuse_bucket: Optional[Tuple] = None
    reuse_variant: str = "reuse"
    # kv_layout sample (auto mode), fed at retire: the admission wall
    # (placement + prefill) plus this request's share of each decode call
    # that did not capture its graph, extrapolated over the calls that did
    admit_wall: float = 0.0
    admit_bucket: Optional[Tuple] = None
    steps_resident: int = 0
    clean_step_shares: List[float] = dataclasses.field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousBatchingEngine:
    """Token-level continuous batching over a fixed pool of decode slots.

    Engine iteration (:meth:`step`):

    1. **admit** — while a slot is free and the queue is non-empty, pick a
       request (prefix-aware when the cache is on).  A *contiguous*
       admission prefills the whole prompt (or, warm, its suffix) and
       copies its K/V into the slot; a *paged* admission is only placed —
       matched pages aliased, a partial tail cloned copy-on-write, pages
       for the rest allocated, the block-table row installed — and the
       slot starts prefilling;
    2. **prefill chunks** — at most ``chunks_per_step`` chunks run,
       round-robin over prefilling slots; each reads every earlier
       position through the slot's block table and writes its own K/V
       into the slot's pages.  The final chunk yields the first
       generated token (TTFT) and turns the slot to decoding;
    3. **decode** — one call advances every decoding slot by one token, or
       by up to H in a fused horizon (free and prefilling slots decode
       garbage that is discarded);
    4. **retire** — a request hitting EOS or ``max_new_tokens`` completes
       and frees its slot at once (its private pages too; pages the tree
       adopted live on through the tree's reference).

    ``kv_layout`` is ``"contiguous"`` (the default, as the reference's),
    ``"paged"`` or ``"auto"``; ``prefix_blocks`` > 0 turns the prefix
    cache on (``partial_match``: paged admissions may also match the
    leading tokens of one more block, cloned copy-on-write;
    ``sched_window``/``max_skip``: the prefix-aware admission window and
    its starvation bound, per class with ``max_skip_by_class``).
    ``prefill_chunk`` is the chunk size in tokens of paged admissions,
    ``"whole"`` for one chunk per prompt, or ``"auto"`` for the measured
    axis over ``whole`` and ``chunk_choices``.  ``decode_horizon`` is a
    step count >= 1, or ``"auto"`` for the measured axis over 1 and
    ``horizon_choices``.  ``page_budget`` (paged and ``auto`` only, at
    least ``max_len / block_size + 2``) sizes the pool below its worst
    case, ``swap`` resumes preempted requests from host memory instead of
    recomputing them, and ``slo_weight`` >= 0 weighs the queue-wait term
    of the horizon and chunk axes.  ``spec_draft`` is ``"off"``, a verify
    span >= 2 or ``"auto"`` (over ``spec_choices``, by default
    ``horizon_choices``).  ``fault_plan`` injects faults, ``watchdog``
    (True, or a :class:`StepWatchdog`) guards each decode span's fence,
    ``max_request_faults`` is a request's fault budget, ``probation_steps``
    the clean decode spans a demoted rung waits out, ``max_queue_depth``
    the admission bound.  ``device`` defaults to ``"cuda"`` and must hold
    ``params``; ``"cpu"`` runs the kernels' plain versions.
    ``mesh_shape`` is ``(1, mp)``: one engine is one replica.  ``mp > 1``
    shards its heads over ``mp`` processes (module docstring): each builds
    this engine with the whole ``params`` and its ``shard_group`` (``mp``
    ranks), keeps only its shard of them, and must be handed the same
    submissions (``submit`` raises ``ValueError`` on every rank when a
    request differs).  ``mesh_devices``, when given, names the replica's
    device row, one a rank (this rank's takes the place of ``device``),
    and ``shard_dims`` the group's full ``(dp, mp)``, which the measured
    axes' keys carry (:func:`make_serve_engine` passes both).
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 max_len: int = 256, vpe: Optional[VPE] = None,
                 occupancy_levels: int = 4, min_prompt_pad: int = 16,
                 prefix_blocks: int = 0, block_size: int = 16,
                 kv_layout: str = "contiguous", partial_match: bool = True,
                 max_skip: int = 4, sched_window: int = 16,
                 prefill_chunk: Any = "whole",
                 chunks_per_step: Optional[int] = None,
                 chunk_choices: Tuple[int, ...] = (128, 512, 2048),
                 decode_horizon: Any = 1,
                 horizon_choices: Tuple[int, ...] = (4, 16),
                 decode_impl: str = "auto", prefill_kernel: str = "auto",
                 spec_draft: Any = "off",
                 spec_choices: Optional[Tuple[int, ...]] = None,
                 page_budget: Optional[int] = None, swap: bool = False,
                 slo_weight: float = 0.0,
                 max_skip_by_class: Optional[Dict[str, int]] = None,
                 fault_plan: Optional[FaultPlan] = None, watchdog: Any = None,
                 max_request_faults: int = 3, probation_steps: int = 16,
                 max_queue_depth: Optional[int] = None,
                 mesh_shape: Tuple[int, int] = (1, 1),
                 mesh_devices: Optional[Sequence[DeviceLike]] = None,
                 shard_dims: Optional[Tuple[int, int]] = None,
                 shard_group: Optional[ShardGroup] = None,
                 device: DeviceLike = "cuda") -> None:
        if not model_lib.supports_slot_serving(cfg):
            raise ValueError(f"family {cfg.family!r} has no slot-serving path")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, "
                             f"got {kv_layout!r}")
        dp, mp = (int(mesh_shape[0]), int(mesh_shape[1]))
        if dp < 1 or mp < 1:
            raise ValueError(f"mesh_shape axes must be >= 1, got {mesh_shape}")
        if dp > 1:
            raise ValueError(
                "a single engine replica cannot span dp > 1 — use "
                "make_serve_engine / EngineReplicaGroup for dp replicas")
        if mp > 1 and (shard_group is None or shard_group.world != mp):
            raise ValueError(
                f"mesh_shape={tuple(mesh_shape)} shards over {mp} processes: "
                f"build the engine on each rank with its shard_group of {mp} "
                f"ranks (repro_torch.distributed.group.spawn_ranks)")
        rank = shard_group.rank if mp > 1 else 0
        if mesh_devices is not None:
            if len(mesh_devices) != mp:
                raise ValueError(f"mesh_devices names {len(mesh_devices)} "
                                 f"devices for a row of mp={mp}")
            device = mesh_devices[rank]
        if isinstance(prefill_chunk, str):
            if prefill_chunk not in ("whole", "auto"):
                raise ValueError(
                    "prefill_chunk must be a token count, 'whole' or 'auto'")
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
        if max_skip_by_class is not None:
            bad = set(max_skip_by_class) - set(PRIORITY_CLASSES)
            if bad:
                raise ValueError(f"unknown priority classes in "
                                 f"max_skip_by_class: {sorted(bad)}")
        if slo_weight < 0.0:
            raise ValueError("slo_weight must be >= 0")
        if isinstance(spec_draft, str):
            if spec_draft not in ("off", "auto"):
                raise ValueError(
                    "spec_draft must be a verify span >= 2, 'off' or 'auto'")
        elif int(spec_draft) < 2:
            raise ValueError("spec_draft must be >= 2 (a 1-position "
                             "verify is just a decode step — use 'off')")
        if spec_choices is not None and any(int(c) < 2 for c in spec_choices):
            raise ValueError("spec_choices must all be >= 2")
        if max_request_faults < 1:
            raise ValueError("max_request_faults must be >= 1")
        if probation_steps < 1:
            raise ValueError("probation_steps must be >= 1")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        paged_capable = kv_layout in ("paged", "auto")
        if paged_capable and max_len % block_size:
            raise ValueError(f"paged layouts need max_len ({max_len}) divisible "
                             f"by block_size ({block_size})")
        if page_budget is not None and not paged_capable:
            raise ValueError("page_budget only applies to paged/auto layouts")
        if page_budget is not None and page_budget < max_len // block_size + 2:
            # one max_len residency must fit in an otherwise drained pool
            # (its table's pages, a pinned partial original and its
            # copy-on-write clone), or a lone request could never finish
            raise ValueError(
                f"page_budget={page_budget} below the minimum "
                f"{max_len // block_size + 2} (= max_len/block_size + 2) a "
                f"single request needs to make progress")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        # the mesh: this replica's (1, mp) row, and the group's (dp, mp),
        # whose segment goes LAST on every measured axis's key — none on
        # a (1, 1) mesh, so single-engine keys stay byte-identical.  A
        # rank of a sharded engine keeps its shard of the params and runs
        # the model, its pool and its kernels under the shard-local config
        self.shards: Optional[ShardScope] = None
        if mp > 1:
            self.shards = ShardScope(shard_group, shard_plan(cfg, mp))
            params, cfg = shard_params(cfg, params, mp, rank)
        self.mesh_shape = (dp, mp)
        self._shard_dims = (tuple(int(d) for d in shard_dims)
                            if shard_dims is not None else self.mesh_shape)
        self._shard_tail: Tuple = (shard_bucket(*self._shard_dims)
                                   if self._shard_dims != (1, 1) else ())
        self.cfg = cfg
        self.params = params
        self.num_slots = slots
        self.max_len = max_len
        self.vpe = vpe
        self.occupancy_levels = occupancy_levels
        self.min_prompt_pad = min_prompt_pad
        self.block_size = block_size
        self.kv_layout = kv_layout
        self.partial_match = partial_match
        self.max_skip = max_skip
        self.max_skip_by_class = max_skip_by_class
        self.sched_window = sched_window
        self.swap = swap
        self.slo_weight = slo_weight
        self.prefill_chunk = (prefill_chunk if prefill_chunk == "auto"
                              else 0 if prefill_chunk == "whole"
                              else int(prefill_chunk))
        self.chunk_choices = tuple(int(c) for c in chunk_choices)
        self.chunks_per_step = chunks_per_step
        self.decode_horizon = (decode_horizon if decode_horizon == "auto"
                               else int(decode_horizon))
        self.horizon_choices = tuple(int(h) for h in horizon_choices)
        self.decode_impl = decode_impl
        self.prefill_kernel = prefill_kernel
        # speculation needs a block table to write the candidates through,
        # and is a variant of the multi-token decode call: a contiguous
        # engine or decode_horizon=1 resolves any span to "off"
        self.spec_draft = (spec_draft if isinstance(spec_draft, str)
                           else int(spec_draft))
        if self.spec_draft != "off" and not (
                paged_capable and self.decode_horizon != 1):
            self.spec_draft = "off"
        self.spec_choices = (tuple(int(c) for c in spec_choices)
                             if spec_choices is not None
                             else self.horizon_choices)
        self.proposer: Optional[NGramProposer] = (
            NGramProposer() if self.spec_draft != "off" else None)
        # EMA of the per-call acceptance fraction (None until measured), the
        # spec axis's acceptance level; fed by the verify calls and, one
        # plain call in ``_probe_every``, by the counterfactual probe
        self._accept_ema: Optional[float] = None
        self._probe_every = 4
        self._probe_tick = 0
        self._spec_off_pending: Optional[Tuple[Tuple, str]] = None
        # faults: the plan (None in production: each hook is one None
        # check), the fence watchdog, the per-request budget, the probation
        # window, the admission bound, and the demoted rungs with the clean
        # decode spans each still owes
        self.faults = fault_plan
        if watchdog is True:
            watchdog = StepWatchdog()
        self.watchdog: Optional[StepWatchdog] = watchdog or None
        self.max_request_faults = max_request_faults
        self.probation_steps = probation_steps
        self.max_queue_depth = max_queue_depth
        self._demoted: Dict[str, int] = {}
        self._deadlines_live = False
        self.stats = ServeStats()
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        # set to a dict to keep each admission's prompt-last-position
        # logits (V,) by request id, on the engine's device
        self.first_logits: Optional[Dict[int, torch.Tensor]] = None
        self.slots = [_Slot() for _ in range(slots)]
        self._chunk_rr = 0           # round-robin cursor over prefilling slots
        self._masks_dirty = True
        self._axis = "serve_decode_impl"
        if vpe is not None and not vpe.registry.has_op(self._axis):
            # a pinned decode_impl registers the axis as a SYSTEM op:
            # samples are recorded under the name that ran, never trialed.
            # Without pages the kernel variant is grouped: not offered.
            vpe.registry.register_op(self._axis, system=(decode_impl != "auto"))
            names = [n for n in SERVE_AXES[self._axis]
                     if paged_capable or n not in kvcache.PAGED_KERNEL_IMPLS]
            for i, name in enumerate(names):
                vpe.registry.register_variant(
                    self._axis, name, fn=(lambda name=name: name), default=(i == 0))
        if vpe is not None and paged_capable and prefill_kernel == "auto" \
                and not vpe.registry.has_op("prefill_kernel"):
            vpe.registry.register_op("prefill_kernel")
            for i, name in enumerate(SERVE_AXES["prefill_kernel"]):
                vpe.registry.register_variant(
                    "prefill_kernel", name, fn=(lambda name=name: name),
                    default=(i == 0))
        if vpe is not None and paged_capable and prefill_chunk == "auto" \
                and not vpe.registry.has_op("prefill_chunk"):
            # "whole" (one chunk a prompt) is the incumbent; the sizes of
            # chunk_choices are the candidates, trialed per prompt-length x
            # occupancy bucket and fed from an admission's chunk walls
            vpe.registry.register_op("prefill_chunk")
            names = ["whole"] + [str(c) for c in self.chunk_choices]
            for i, name in enumerate(names):
                vpe.registry.register_variant(
                    "prefill_chunk", name, fn=(lambda name=name: name),
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
        if vpe is not None and self.spec_draft == "auto" \
                and not vpe.registry.has_op("spec_draft"):
            # "off" (the plain decode call) is the incumbent; the spans of
            # spec_choices are the candidates, trialed per queue-depth x
            # occupancy x acceptance-level bucket and fed from the wall a
            # committed token of the whole span
            vpe.registry.register_op("spec_draft")
            names = ["off"] + [str(c) for c in self.spec_choices]
            for i, name in enumerate(names):
                vpe.registry.register_variant(
                    "spec_draft", name, fn=(lambda name=name: name),
                    default=(i == 0))
        if vpe is not None and kv_layout == "auto" \
                and not vpe.registry.has_op("kv_layout"):
            vpe.registry.register_op("kv_layout")
            for i, name in enumerate(SERVE_AXES["kv_layout"]):
                vpe.registry.register_variant(
                    "kv_layout", name, fn=(lambda name=name: name),
                    default=(i == 0))
        # -- KV storage: a paged-capable pool holds the worst case of every
        # slot's block table (x2 under auto, where contiguous admissions
        # pin tree pages no table owns) plus one pinned partial page a
        # slot, plus the prefix cache's headroom, so placement and decode
        # growth never run dry — unless ``page_budget`` sizes it below
        # that, and eviction and preemption recover
        self.nb_max = max_len // block_size if paged_capable else 0
        self.pages: Optional[PagePool] = None
        self.page_pool: Optional[kvcache.Cache] = None
        if paged_capable:
            n_pages = (slots * self.nb_max * (2 if kv_layout == "auto" else 1)
                       + slots + max(prefix_blocks, 0))
            if page_budget is not None:
                n_pages = page_budget
            self.pages = PagePool(n_pages)
            self.page_pool = model_lib.init_page_pool(cfg, n_pages, block_size,
                                                      self.device)
        if kv_layout == "paged":
            self.cache = model_lib.init_paged_cache(
                cfg, slots, max_len, block_size, self.pages.trash_id, self.device)
        elif kv_layout == "auto":
            self.cache = {
                **model_lib.init_slot_cache(cfg, slots, max_len, self.device),
                "bt": model_lib.init_paged_cache(
                    cfg, slots, max_len, block_size, self.pages.trash_id,
                    self.device)["bt"]}
        else:
            self.cache = model_lib.init_slot_cache(cfg, slots, max_len,
                                                   self.device)
        # -- shared-prefix KV cache: on paged-capable engines the tree's
        # pages are the pool's (one id space); on the contiguous layout it
        # owns a block pool of its own, in the compute dtype
        self.prefix_cache: Optional[PrefixCache] = None
        self.block_pool: Optional[kvcache.Cache] = None
        if prefix_blocks > 0:
            if paged_capable:
                self.prefix_cache = PrefixCache(self.pages.num_pages, block_size,
                                                pool=self.pages)
            else:
                self.prefix_cache = PrefixCache(prefix_blocks, block_size)
                self.block_pool = kvcache.init_block_pool(
                    prefix_blocks, cfg.num_layers, cfg.num_kv_heads, block_size,
                    cfg.head_dim, dtype=getattr(torch, cfg.dtype),
                    device=self.device)
            if vpe is not None and not vpe.registry.has_op("prefix_reuse"):
                vpe.registry.register_op("prefix_reuse")
                for i, name in enumerate(SERVE_AXES["prefix_reuse"]):
                    vpe.registry.register_variant(
                        "prefix_reuse", name, fn=(lambda name=name: name),
                        default=(i == 0))
        # device-side decode inputs, rows INPUT_ROWS (tok, live, eos,
        # paged, budget): rewritten in place from the host slot mirrors
        # only after an admission / prefill completion / retire (and the
        # budget before each call); a steady decode call feeds its own
        # final tokens back into ``tok`` on the device.  These, the cache
        # and the pool are never rebound: the decode graphs replay over
        # them.
        self._inputs = torch.zeros((len(INPUT_ROWS), slots), dtype=torch.int32,
                                   device=self.device)
        self.graphs = DecodeGraphs(cfg, params, kv_layout, self.cache,
                                   self._inputs, pool=self.page_pool,
                                   eager=self.shards is not None)
        if self.device.type == "cuda":
            # build and load the kernels the layout runs now, and launch
            # each once: the port's capability check, which raises
            # instead of degrading
            if paged_capable:
                from repro_torch.kernels.paged_attention import prepare
                prepare(self.page_pool["k"].dtype, cfg.num_heads,
                        cfg.num_kv_heads, cfg.head_dim, block_size, self.device)
            if kv_layout != "paged" and cfg.attn_impl == "flash_cuda":
                from repro_torch.kernels.flash_attention import \
                    prepare as prepare_flash
                prepare_flash(getattr(torch, cfg.dtype), cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim, self.device)

    # -- request intake ----------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue a request, or terminally fail one the engine can never
        serve (``status="failed"``, ``error="intake"``) or that finds the
        queue at ``max_queue_depth`` (``error="capacity"``: load is shed
        while it is a host-side entry, before it competes for pages) — a
        bad request must not throw at a caller batching thousands.  On a
        sharded engine every rank must submit the same request: a
        ``ValueError`` on every rank when one differs."""
        req.submit_t = self._agreed_submit(req)
        err = _intake_error(req, self.max_len)
        if err is not None:
            self._fail_request(req, "intake", err)
            return
        if self.max_queue_depth is not None \
                and len(self.queue) >= self.max_queue_depth:
            self._fail_request(
                req, "capacity",
                f"queue depth {len(self.queue)} at admission bound "
                f"{self.max_queue_depth}")
            return
        if req.deadline_s is not None:
            self._deadlines_live = True
        req.status = "queued"
        self.queue.append(req)

    # -- head sharding: rank 0 decides -------------------------------------
    def _decide(self, fn):
        """``fn()`` — a decision that reads a clock or a measured time — on
        an unsharded engine; on a sharded one, rank 0's ``fn()`` on every
        rank (the others do not call it)."""
        if self.shards is None:
            return fn()
        group = self.shards.group
        return group.agree(fn() if group.rank == 0 else None)

    def _now(self) -> float:
        """The clock the deadlines are read against (rank 0's)."""
        return self._decide(time.perf_counter)

    def _agreed_submit(self, req: Request) -> float:
        """The submit time of ``req`` (rank 0's clock), after checking that
        every rank was handed the same request."""
        now = time.perf_counter()
        if self.shards is None:
            return now
        return _agree_request(self.shards.group, req, now)

    def _agree_call(self, host: np.ndarray, tripped: bool
                    ) -> Tuple[np.ndarray, bool]:
        """Rank 0's fenced tokens (and watchdog verdict) of a decode or
        verify call, on every rank; a rank whose own tokens differed counts
        it and re-uploads its token row from the host mirrors."""
        if self.shards is None:
            return host, tripped
        host0, tripped0 = self.shards.group.agree((host, tripped))
        if not np.array_equal(host0, host):
            self.stats.shard_token_mismatch += 1
            self._masks_dirty = True
        return host0, tripped0

    def _fail_request(self, req: Request, reason: str, detail: str,
                      slot: Optional[int] = None) -> None:
        """Terminally fail a request, from intake to mid-flight: the reason
        code and message recorded, ``done_t`` stamped, completed at once.
        A never-admitted request records its queue wait and counts in
        ``rejected``; an admitted one keeps the wait its admission
        recorded.  ``slot`` first detaches a resident request: its pages
        released, its prefix pin dropped, its draft context forgotten."""
        assert reason in FAIL_REASONS, reason
        if slot is not None:
            s = self.slots[slot]
            if s.layout == "paged" and s.pages:
                self._release_slot_pages(slot)
            s.req = None
            s.prefilling = False
            s.fill_pos = 0
            s.pos = 0
            s.chunk_walls = []
            s.chunk_costs = []
            s.reuse_bucket = None
            s.chunk_bucket = None
            s.kernel_bucket = None
            s.admit_bucket = None
            if self.proposer is not None:
                self.proposer.forget_slot(slot)
            self._masks_dirty = True
        if req.cache_handle is not None:
            self.prefix_cache.release(req.cache_handle)
            req.cache_handle = None
        req.swap = None
        req.error = reason
        req.error_detail = detail
        req.status = "failed"
        req.done = True
        req.done_t = time.perf_counter()
        if req.admit_step < 0:
            req.queue_wait_s = req.done_t - req.submit_t
            self.stats.rejected += 1
        else:
            req.done_step = self.stats.decode_steps
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
        """Page audit: the tree's invariants hold, and pool refcounts are
        exactly tree ownership plus the live block tables' pages.  Raises
        AssertionError on a leak or a dangling reference."""
        if self.prefix_cache is not None:
            self.prefix_cache.check()
        if self.pages is None:
            return
        owners: Dict[int, int] = {}
        if self.prefix_cache is not None:
            for pid in self.prefix_cache.owned_pages():
                owners[pid] = owners.get(pid, 0) + 1
        for s in self.slots:
            for pid in s.pages:
                owners[pid] = owners.get(pid, 0) + 1
        self.pages.check(owners)

    def _requeue(self, req: Request) -> None:
        """Put a rolled-back or preempted request back in the queue: at the
        head of its own class, behind every better class.  At the queue's
        head a rolled-back batch request would sit before waiting
        interactive ones, be jumped by each of them and reach its skip
        bound ahead of traffic that outranks it; here nobody is charged a
        skip."""
        rank = PRIORITY_RANK[req.priority]
        pos = next((j for j, r in enumerate(self.queue)
                    if PRIORITY_RANK[r.priority] >= rank), len(self.queue))
        self.queue.insert(pos, req)

    # -- page accounting ---------------------------------------------------
    def _alloc_page(self, *, exclude: int, rank: int,
                    decode_growth: bool = False) -> int:
        """A page from the pool, escalating while it is dry: the free list,
        then evicting an unpinned cached prefix, then preempting a victim
        slot (:meth:`_pick_victim`).  ``exclude`` shields the slot the page
        is for, ``rank`` is its request's class rank, ``decode_growth``
        marks a decoding slot's next block (mid-horizon there is no host to
        wait for one).  :class:`_PagePressure` when nothing is left: the
        caller recovers (placement rolls back, growth preempts the
        grower).  A planned ``page_alloc`` fault raises
        :class:`SimulatedFault` instead, which the same callers roll back
        and charge to the request."""
        if self._take_fault("page_alloc") is not None:
            raise SimulatedFault(
                f"injected page-pool allocation fault at call "
                f"#{self.faults.calls['page_alloc'] - 1}")
        pid = self.pages.alloc()
        while pid is None:
            if self.prefix_cache is not None and self.prefix_cache.evict(1):
                pid = self.pages.alloc()
                continue
            victim = self._pick_victim(exclude, rank, decode_growth)
            if victim is None:
                raise _PagePressure(
                    "page demand exceeds the free list, evictable prefixes "
                    "and preemptible slots")
            self._preempt_slot(victim)
            pid = self.pages.alloc()
        return pid

    def _skip_budget(self, req: Request) -> int:
        """The request's starvation bound: its class's ``max_skip_by_class``
        entry, else ``max_skip``."""
        if self.max_skip_by_class is not None:
            return self.max_skip_by_class.get(req.priority, self.max_skip)
        return self.max_skip

    def _queue_pressure(self) -> float:
        """Class-weighted count of queued requests: the second term of the
        scheduler objective.  Every queued request waits out the next long
        device call, so that call is charged ``wall x (1 + slo_weight x
        pressure)``."""
        return sum(SLO_CLASS_WEIGHT.get(r.priority, 1.0) for r in self.queue)

    def _slo_bucket(self) -> Tuple:
        """The queue's composition, appended to the horizon and chunk keys
        when ``slo_weight`` > 0."""
        ni = sum(1 for r in self.queue if r.priority == "interactive")
        return slo_pressure_bucket(ni, len(self.queue) - ni)

    def _pick_victim(self, exclude: int, rank: int,
                     decode_growth: bool) -> Optional[int]:
        """The slot to preempt for pages, or None.  Prefilling victims come
        before decoding ones (a paused prefill loses only work that can be
        placed again); within a tier the lowest class, then the latest
        admitted, then the least filled.  An admission takes only a lower
        class's prefill; decode growth also takes an equal class's prefill
        and a lower class's decoder.  A slot that would free nothing (no
        pages, no pin) is never picked."""
        prefills: List[Tuple[int, int, int, int]] = []
        decodes: List[Tuple[int, int, int, int]] = []
        for j, s in enumerate(self.slots):
            if j == exclude or s.req is None:
                continue
            if not s.pages and s.req.cache_handle is None:
                continue
            vr = PRIORITY_RANK[s.req.priority]
            if s.prefilling:
                if vr > rank or (decode_growth and vr >= rank):
                    prefills.append((vr, s.req.admit_step, -s.fill_pos, j))
            elif decode_growth and vr > rank:
                decodes.append((vr, s.req.admit_step, -len(s.req.out), j))
        for tier in (prefills, decodes):
            if tier:
                return max(tier)[3]
        return None

    def _preempt_slot(self, j: int) -> None:
        """Preempt slot ``j``: with ``swap`` its filled K/V goes to host
        memory first (:meth:`_swap_out`); its pages go back to the pool, its
        prefix pin is released, and its request is requeued at the head of
        its class (``status="preempted"``).  The slot's block-table row and
        length stay as they were: the masks refresh before the next decode
        call, and a slot that is not live appends to the trash page, so the
        stale row is never written through."""
        slot = self.slots[j]
        req = slot.req
        was_decoding = not slot.prefilling
        if self.swap and slot.layout == "paged":
            filled = slot.pos if was_decoding else slot.fill_pos
            if filled > 0:
                self._swap_out(j, filled)
        if slot.layout == "paged" and slot.pages:
            if req.swap is not None:
                self.pages.swap_out(slot.pages)
                slot.pages = []
            else:
                self._release_slot_pages(j)
        if req.cache_handle is not None:
            self.prefix_cache.release(req.cache_handle)
            req.cache_handle = None
        req.preemptions += 1
        req.status = "preempted"
        self.stats.preemptions += 1
        if was_decoding:
            self.stats.decode_preemptions += 1
        slot.req = None
        slot.prefilling = False
        slot.fill_pos = 0
        slot.pos = 0
        slot.chunk_walls = []
        slot.chunk_costs = []
        slot.reuse_bucket = None
        slot.chunk_bucket = None
        slot.kernel_bucket = None
        slot.admit_bucket = None
        if self.proposer is not None:
            # the slot's draft context only: the table is the memory across
            # requests, and the re-admission seeds the context again
            self.proposer.forget_slot(j)
        self._requeue(req)
        self._masks_dirty = True

    def _swap_out(self, j: int, filled: int) -> None:
        """Copy slot ``j``'s filled K/V to host memory (pinned, fenced)
        before its pages are given away.  The page count is padded to a
        power of two by repeating the first id (few distinct shapes);
        ``filled`` travels with the copy."""
        slot = self.slots[j]
        bs = self.block_size
        nb = -(-filled // bs)                       # ceil
        ids = slot.pages[:nb]
        nb_pad = pad_to_bucket(nb, minimum=1)
        t0 = time.perf_counter()
        k, v = kvcache.swap_out_pages(
            self.page_pool, torch.tensor(ids + [ids[0]] * (nb_pad - nb),
                                         dtype=torch.int64, device=self.device))
        slot.req.swap = (k, v, filled)
        self.stats.swap_out_s.append(time.perf_counter() - t0)
        self.stats.swap_outs += 1
        self.stats.swapped_pages += nb

    def _swap_in_slot(self, i: int) -> int:
        """Scatter a swap-resumed request's host K/V into the pages its
        placement just allocated, fenced; returns the position the prefill
        resumes at (the preempted residency's ``filled``).  Padding takes
        the trash id and a negative start, so it writes nothing."""
        slot = self.slots[i]
        req = slot.req
        k, v, filled = req.swap
        bs = self.block_size
        nb = -(-filled // bs)                       # ceil
        nb_pad = k.shape[3] // bs                   # the swap-out's padding
        ids = slot.pages[:nb] + [self.pages.trash_id] * (nb_pad - nb)
        starts = [b * bs for b in range(nb)] + [-bs] * (nb_pad - nb)
        t0 = time.perf_counter()
        kvcache.swap_in_pages(self.page_pool, k, v, torch.tensor(ids),
                              torch.tensor(starts), filled)
        fence(self.device)
        self.stats.swap_in_s.append(time.perf_counter() - t0)
        req.swap = None
        self.stats.swap_ins += 1
        return filled

    # -- faults: the recovery ladder ------------------------------------------
    # A faulted span quarantines the VARIANT before the request: each rung
    # names a dispatch decision with a safe bottom — decode_cuda (the
    # decode kernel -> grouped), prefill_cuda (the prefill kernel ->
    # gather), spec (-> off), horizon (-> single steps).  A demotion pins
    # the safe variant through the resolvers for ``probation_steps`` clean
    # decode spans, then lifts; the VPE's state is never touched.

    def _take_fault(self, site: str):
        """The injection hook: the plan's fault for this call of ``site``,
        or None (always None without a plan)."""
        return self.faults.take(site) if self.faults is not None else None

    def _rung_demoted(self, rung: str) -> bool:
        return rung in self._demoted

    def _demote(self, rung: str) -> None:
        """Quarantine a rung for a fresh probation window (a repeated fault
        refreshes the window without counting a second demotion).  A
        demoted prefill kernel also re-resolves the slots mid-prefill:
        their next chunk must not run it again."""
        if rung not in self._demoted:
            self.stats.demotions[rung] = self.stats.demotions.get(rung, 0) + 1
        self._demoted[rung] = self.probation_steps
        if rung == "prefill_cuda":
            for s in self.slots:
                if s.prefilling and s.kernel in kvcache.PAGED_KERNEL_IMPLS:
                    s.kernel = "gather"
                    s.kernel_bucket = None      # walls of two backends: drop

    def _tick_probation(self) -> None:
        """One clean decode span (no fault taken, no trip): every demoted
        rung's window counts down, and at zero the rung is re-promoted."""
        for rung in list(self._demoted):
            self._demoted[rung] -= 1
            if self._demoted[rung] <= 0:
                del self._demoted[rung]
                self.stats.repromotions += 1

    def _charge_fault(self, req: Request) -> bool:
        """Charge one fault to the request; True when its budget is spent
        and it must fail."""
        req.faults += 1
        return req.faults >= self.max_request_faults

    def _numeric_fault(self, i: int, detail: str) -> None:
        """Quarantine slot ``i`` after poisoned logits: whatever the span
        wrote into its KV is untrusted, so it is preempted WITHOUT swap
        (swap would keep the poison) and resumes by recomputing from its
        committed tokens, or fails when its fault budget is spent.  Decode
        writes land only in the slot's private tail pages, so releasing
        them drops every tainted byte."""
        slot = self.slots[i]
        self.stats.numeric_faults += 1
        if self._charge_fault(slot.req):
            self._fail_request(slot.req, "numeric_fault", detail, slot=i)
            return
        swap_save, self.swap = self.swap, False
        try:
            self._preempt_slot(i)
        finally:
            self.swap = swap_save

    def _span_device_fault(self, rung: Optional[str], touched: List[int],
                           detail: str) -> None:
        """Recover from a device fault at a decode span, taken before the
        launch: engine state is intact and the touched slots retry next
        step.  The variant takes the blame first (``rung`` is demoted);
        with no rung left to blame (none given, or already demoted) each
        touched request is charged and fails when its budget is spent.
        Reserved pages the span did not write go back either way."""
        self.stats.device_faults += 1
        variant_blamed = rung is not None and not self._rung_demoted(rung)
        if rung is not None:
            self._demote(rung)
        for i in touched:
            slot = self.slots[i]
            if slot.req is None or slot.prefilling:
                continue
            if not variant_blamed and self._charge_fault(slot.req):
                self._fail_request(slot.req, "device_fault", detail, slot=i)
            elif slot.layout == "paged":
                self._rollback_reserved(i)

    def _guarded_fence(self, value: torch.Tensor, fault
                       ) -> Tuple[np.ndarray, bool]:
        """Fence a decode span's device output through the watchdog when one
        is armed; returns (the value on the host, tripped).  A trip — a
        planned ``stall`` or a real fence past the watchdog's budget —
        keeps the span (its value arrived, late): the caller commits it and
        demotes the variant that stalled.  The watchdog raises after its
        fence has drained, so the copy after it does not wait again.  On a
        sharded engine the value and the verdict are rank 0's
        (:meth:`_agree_call`)."""
        tripped = False
        if fault is not None and fault.kind == "stall":
            # planned stall: a trip without sleeping through one
            if self.watchdog is not None:
                self.watchdog.trips += 1
            host, tripped = value.cpu().numpy(), True
        elif self.watchdog is not None:
            try:
                host = self.watchdog.guard(value).cpu().numpy()
            except StragglerTimeout:
                host, tripped = value.cpu().numpy(), True
        else:
            host = value.cpu().numpy()
        host, tripped = self._agree_call(host, tripped)
        if tripped:
            self.stats.watchdog_trips += 1
        return host, tripped

    def _deadline_expired(self, req: Request, now: float) -> bool:
        return (req.deadline_s is not None
                and now - req.submit_t > req.deadline_s)

    def _shed_expired(self) -> None:
        """The deadline sweep at the top of :meth:`step` (armed once a
        request with a deadline was submitted): expired queued requests
        are shed on the host, expired resident ones stop decoding."""
        if not self._deadlines_live:
            return
        now = self._now()
        expired = [r for r in self.queue if self._deadline_expired(r, now)]
        if expired:
            self.queue = [r for r in self.queue
                          if not self._deadline_expired(r, now)]
            for r in expired:
                self._fail_request(
                    r, "deadline",
                    f"expired in queue after {now - r.submit_t:.3f}s "
                    f"(deadline {r.deadline_s:.3f}s)")
        for i, s in enumerate(self.slots):
            if s.req is not None and not s.req.canary \
                    and self._deadline_expired(s.req, now):
                self._fail_request(
                    s.req, "deadline",
                    f"expired after {now - s.req.submit_t:.3f}s resident "
                    f"(deadline {s.req.deadline_s:.3f}s)", slot=i)

    # -- admission ---------------------------------------------------------
    def _pop_next(self) -> Request:
        """The next request to admit.  A request jumped its class's skip
        budget times goes first (the front-most such); otherwise the front
        ``sched_window`` entries are narrowed to the best class present
        (interactive before batch), and among those the longest cached
        prefix wins (the front-most without a prefix cache), so requests
        sharing a resident prefix are co-scheduled.  Every jumped request's
        ``skips`` ticks, so request i is admitted within ``(max_skip + 1) *
        (i + 1)`` admissions: priority decides who goes first, never how
        long anyone waits."""
        if len(self.queue) == 1:
            return self.queue.pop(0)
        forced = next((j for j, r in enumerate(self.queue)
                       if r.skips >= self._skip_budget(r)), None)
        if forced is not None:
            best = forced
        else:
            window = self.queue[:self.sched_window]
            ranks = [PRIORITY_RANK[r.priority] for r in window]
            best_rank = min(ranks)
            if self.prefix_cache is None:
                best = ranks.index(best_rank)
            else:
                best, best_len = 0, -1
                for j, r in enumerate(window):
                    if ranks[j] != best_rank:
                        continue
                    m = self.prefix_cache.probe(r.prompt,
                                                max_match=len(r.prompt) - 1)
                    if m > best_len:
                        best, best_len = j, m
        for r in self.queue[:best]:
            r.skips += 1
        self.stats.sched_skips += best
        return self.queue.pop(best)

    def _admit(self) -> None:
        while self.queue:
            # re-scan each time: a request finishing at prefill (e.g.
            # max_new_tokens == 1) frees its slot for the next in queue
            i = next((j for j, s in enumerate(self.slots) if s.free), None)
            if i is None:
                return
            slot = self.slots[i]
            req = self._pop_next()
            now = self._now()
            if self._deadline_expired(req, now):
                # expired while queued: shed at the admission edge, before
                # placement and prefill are spent on it
                self._fail_request(
                    req, "deadline",
                    f"expired in queue after {now - req.submit_t:.3f}s "
                    f"(deadline {req.deadline_s:.3f}s)")
                continue
            if req.admit_step < 0:
                # first admission only: a preempted or rolled-back request
                # keeps its record
                req.admit_step = self.stats.decode_steps
                req.queue_wait_s = now - req.submit_t
                self.stats.queue_wait_s.append(req.queue_wait_s)
            req.status = "running"
            # a preempted request resumes by prefilling its prompt and the
            # tokens it already emitted
            prompt = req.effective_prompt()
            S = len(prompt)
            occ = self.num_active           # occupancy excluding this slot
            matched = 0
            if self.prefix_cache is not None:
                # never match the whole prompt: the prefill must produce
                # the first token's logits.  A partial tail match needs a
                # layout that can clone the block copy-on-write.  A swap
                # resume matches nothing: its host K/V covers the filled
                # range whole, and the tree may have changed meanwhile.
                allow_partial = (self.partial_match
                                 and self.kv_layout in ("paged", "auto"))
                req.cache_handle = self.prefix_cache.acquire(
                    prompt, max_match=(0 if req.swap is not None else S - 1),
                    allow_partial=allow_partial and req.swap is None)
                matched = req.cache_handle.matched_len
                self.stats.prefix_lookups += 1
            # the layout sees the raw match; hits and the prefix_reuse axis
            # see what the chosen layout can reuse (contiguous: full blocks).
            # Swapped K/V goes back only into a block table.
            if req.swap is not None:
                layout, lbucket = "paged", None
            else:
                layout, lbucket = self._select_layout(matched)
            use_matched = (matched if layout == "paged"
                           else self.block_size * len(req.cache_handle.nodes)
                           if req.cache_handle is not None else 0)
            variant, rbucket = "reuse", None
            if use_matched:
                self.stats.prefix_hits += 1
                if self.vpe is not None:
                    rbucket = prefix_len_bucket(use_matched)
                    variant = self._decide(lambda: self.vpe.controller.select(
                        "prefix_reuse", rbucket))
            slot.req = req
            slot.layout = layout
            slot.admit_bucket = lbucket
            slot.tainted = False
            if layout == "paged":
                # placement only; the prompt runs as chunks between decode
                # steps (:meth:`_run_prefill_chunks`).  When the whole
                # ladder runs dry the placement has rolled back: requeue
                # and stop admitting this step (resident slots go on and
                # free pages; the floor means a lone request fits)
                try:
                    self._place_paged(i, req,
                                      use_matched if variant == "reuse" else 0,
                                      rbucket, variant, occ)
                except _PagePressure:
                    self._unadmit(i, req)
                    return
                except SimulatedFault as e:
                    # an injected allocation fault: the placement already
                    # rolled its references back, so the pool is clean;
                    # charge the request, then retry it later or fail it
                    self.stats.device_faults += 1
                    if self._charge_fault(req):
                        self._fail_request(req, "device_fault", str(e), slot=i)
                        continue
                    self._unadmit(i, req)
                    return
                continue
            # -- contiguous: the whole admission at once
            t0 = time.perf_counter()
            if use_matched and variant == "reuse":
                first, k_all, v_all, base = self._prefill_from_prefix(
                    i, prompt, req.cache_handle)
                self.stats.prefix_tokens_saved += use_matched
            else:
                first, k_all, v_all, base = self._prefill_full(i, prompt)
            fence(self.device)
            dt = time.perf_counter() - t0
            self.stats.prefill_s += dt
            if rbucket is not None:
                # the admission's TTFT contribution feeds the reuse axis
                self.vpe.profiler.record("prefix_reuse", variant, rbucket, dt)
                self.vpe.controller.on_sample("prefix_reuse", rbucket, variant)
            slot.admit_wall = dt
            self._enter_decode(i, first)
            # the first token is out: the prompt's new full blocks enter
            # the tree off the TTFT path
            self._cache_extend(req, k_all, v_all, base, slot)
            self._retire_if_done(i)

    def _unadmit(self, i: int, req: Request) -> None:
        """Undo an admission whose placement rolled back: free the slot,
        unpin the prefix handle, requeue the request at the head of its
        class (:meth:`_requeue`).  Its queue-wait record stands."""
        slot = self.slots[i]
        slot.req = None
        slot.prefilling = False
        slot.admit_bucket = None
        slot.reuse_bucket = None
        slot.chunk_bucket = None
        if req.cache_handle is not None:
            self.prefix_cache.release(req.cache_handle)
            req.cache_handle = None
        req.status = "queued"
        self._requeue(req)
        self._masks_dirty = True

    def _select_layout(self, matched: int) -> Tuple[str, Optional[Tuple]]:
        """This admission's KV layout and, under ``auto``, its bucket."""
        if self.kv_layout != "auto":
            return self.kv_layout, None
        bucket = kv_layout_bucket(matched, self.num_active, self.num_slots,
                                  levels=self.occupancy_levels)
        if self.vpe is None:
            return "contiguous", bucket
        return self._decide(
            lambda: self.vpe.controller.select("kv_layout", bucket)), bucket

    def _first_token(self, i: int, logits: torch.Tensor) -> int:
        """Slot ``i``'s next token after a prefill: the greedy argmax of the
        last-position logits (1, V).  A request's first such logits (not a
        resumed residency's) are kept in :attr:`first_logits` when that is
        a dict."""
        req = self.slots[i].req
        if self.first_logits is not None and not req.ttft_recorded:
            self.first_logits[req.rid] = logits[0].detach().clone()
        tok = int(torch.argmax(logits[0]))
        if self.shards is None:
            return tok
        # rank 0's token, as after a decode call
        tok0 = self.shards.group.agree(tok)
        self.stats.shard_token_mismatch += tok0 != tok
        return tok0

    # -- contiguous admission ------------------------------------------------
    def _prefill_full(self, i: int, prompt: np.ndarray):
        """Cold: run the whole prompt and insert it at slot position 0."""
        S = len(prompt)
        pad = min(pad_to_bucket(S, minimum=self.min_prompt_pad), self.max_len)
        toks = np.zeros((1, pad), np.int32)
        toks[0, :S] = prompt
        k, v, logits = model_lib.prefill_slot_kv(
            self.cfg, self.params, torch.from_numpy(toks).to(self.device), S)
        # fence the prefill before the placement timer, or its compute
        # would be booked as placement
        fence(self.device)
        t0 = time.perf_counter()
        kvcache.insert_slot_kv(self.cache, k, v, i, S)
        fence(self.device)
        self.stats.kv_place_s.append(time.perf_counter() - t0)
        return self._first_token(i, logits), k, v, 0

    def _prefill_from_prefix(self, i: int, prompt: np.ndarray, handle):
        """Warm: gather the matched full blocks, COPY them into the slot's
        region, prefill only the suffix and insert it after them.  Page
        ids are padded to a power-of-two count with a repeated pinned id
        (the reference's gather shapes); the padding's columns lie past
        the prefix and are masked, and the suffix write covers them."""
        S = len(prompt)
        bs = self.block_size
        P = bs * len(handle.nodes)
        nb = P // bs
        nb_pad = min(pad_to_bucket(nb, minimum=1), self.max_len // bs)
        ids = torch.tensor(handle.block_ids + [handle.block_ids[0]] * (nb_pad - nb),
                           dtype=torch.int64, device=self.device)
        t0 = time.perf_counter()
        pk, pv = self._gather_prefix(ids)
        kvcache.insert_slot_kv_at(self.cache, pk, pv, i, 0, S)
        fence(self.device)
        self.stats.kv_place_s.append(time.perf_counter() - t0)
        sl = S - P
        pad_s = min(pad_to_bucket(sl, minimum=self.min_prompt_pad),
                    self.max_len - P)
        toks = np.zeros((1, pad_s), np.int32)
        toks[0, :sl] = prompt[P:]
        k, v, logits = model_lib.prefill_suffix_kv(
            self.cfg, self.params, torch.from_numpy(toks).to(self.device),
            pk, pv, P, sl)
        kvcache.insert_slot_kv_at(self.cache, k, v, i, P, S)
        return self._first_token(i, logits), k, v, P

    def _gather_prefix(self, ids: torch.Tensor):
        """Cached prefix pages from whichever pool holds the tree's pages."""
        if self.pages is not None:
            return kvcache.gather_pages(self.page_pool, ids)
        return kvcache.gather_blocks(self.block_pool, ids)

    # -- paged admission -----------------------------------------------------
    def _bt_row(self, pages: List[int]) -> np.ndarray:
        """A slot's full (nb_max,) block-table row, trash-padded past its
        allocated pages."""
        row = np.full((self.nb_max,), self.pages.trash_id, np.int32)
        row[:len(pages)] = pages
        return row

    def _release_slot_pages(self, i: int) -> None:
        """Drop the slot's page references (pages the tree adopted or this
        slot aliased live on through the tree's own reference)."""
        for pid in self.slots[i].pages:
            self.pages.unref(pid)
        self.slots[i].pages = []

    def _suffix_page_ids(self, base: int, S: int, cow_page: Optional[int],
                         acquired: List[int], *, exclude: int,
                         rank: int) -> List[int]:
        """Pages covering prompt positions ``[base, S)``: ``cow_page`` (the
        clone of a partially matched block) first when ``base`` is
        mid-block, fresh allocations after it (``exclude``/``rank`` go to
        :meth:`_alloc_page`), each appended to ``acquired`` as it is taken
        (the caller's rollback list)."""
        bs = self.block_size
        ids = []
        b = base // bs
        while b * bs < S:
            if cow_page is not None and b == base // bs and base % bs:
                pid = cow_page
            else:
                pid = self._alloc_page(exclude=exclude, rank=rank)
                acquired.append(pid)
            ids.append(pid)
            b += 1
        return ids

    def _place_paged(self, i: int, req: Request, reuse_matched: int,
                     rbucket, variant: str, occ: int) -> None:
        """Placement only, O(1) in matched length: alias the matched full
        pages (one pool reference each), clone a partially matched tail
        block copy-on-write (the first chunk writes into it mid-block),
        allocate pages for the rest of the effective prompt, install the
        block-table row (length stays 0 until the prefill completes — the
        live mask keeps the slot out of decode meanwhile).  A swap resume
        then scatters its host K/V into the fresh pages and its prefill
        starts at the swapped-out fill position.

        All or nothing: if the allocation ladder runs dry midway, every
        reference taken is returned before :class:`_PagePressure` reaches
        :meth:`_admit`."""
        slot = self.slots[i]
        prompt = req.effective_prompt()
        S = len(prompt)
        handle = req.cache_handle
        t0 = time.perf_counter()
        rank = PRIORITY_RANK[req.priority]
        aliased: List[int] = []
        acquired: List[int] = []
        try:
            if reuse_matched:
                P = handle.matched_len
                for pid in handle.block_ids:          # full blocks: zero-copy
                    self.pages.ref(pid)
                    aliased.append(pid)
                cow = None
                if handle.partial_len:
                    cow = self._alloc_page(exclude=i, rank=rank)
                    acquired.append(cow)
                    kvcache.copy_page(self.page_pool, handle.partial_block_id,
                                      cow)
                    self.stats.cow_copies += 1
                pages = aliased + self._suffix_page_ids(
                    P, S, cow, acquired, exclude=i, rank=rank)
            else:
                P = 0
                pages = self._suffix_page_ids(0, S, None, acquired,
                                              exclude=i, rank=rank)
        except (_PagePressure, SimulatedFault):
            # the same all-or-nothing rollback for pressure and for an
            # injected allocation fault: a failed placement leaks no page
            for pid in aliased + acquired:
                self.pages.unref(pid)
            self.stats.placement_rollbacks += 1
            raise
        if P:
            self.stats.prefix_tokens_saved += P
        slot.pages = pages
        self.cache["bt"][i] = torch.from_numpy(self._bt_row(pages)).to(self.device)
        self.cache["length"][i] = 0
        if req.swap is not None:
            P = self._swap_in_slot(i)
        fence(self.device)                     # the COW copy, if any
        dt = time.perf_counter() - t0
        self.stats.kv_place_s.append(dt)
        self.stats.prefill_s += dt
        self.stats.paged_admits += 1
        slot.prefilling = True
        slot.fill_pos = P
        slot.place_wall = dt
        slot.reuse_bucket = rbucket
        slot.reuse_variant = variant
        slot.chunk_walls = []
        slot.chunk_costs = []
        slot.chunk, slot.chunk_bucket, slot.chunk_variant = \
            self._select_chunk(S, occ)
        slot.kernel, slot.kernel_bucket, slot.kernel_variant = \
            self._select_prefill_kernel(S, occ)
        self._masks_dirty = True

    def _select_chunk(self, S: int, occ: int):
        """This admission's chunk size (tokens, 0 = whole) and, under
        ``prefill_chunk="auto"`` with a VPE, its ``prefill_chunk`` bucket
        and variant name (else None, None)."""
        if self.prefill_chunk == "auto" and self.vpe is not None:
            bucket = prefill_chunk_bucket(S, occ, self.num_slots,
                                          levels=self.occupancy_levels)
            if self.slo_weight > 0:
                bucket = bucket + self._slo_bucket()
            bucket = bucket + self._shard_tail
            name = self._decide(
                lambda: self.vpe.controller.select("prefill_chunk", bucket))
            return (0 if name == "whole" else int(name)), bucket, name
        if self.prefill_chunk == "auto":
            return 0, None, None
        return self.prefill_chunk, None, None

    def _resolve_kernel(self, name: str) -> str:
        """The chunk-attention backend that runs: ``gather`` while the
        ``prefill_cuda`` rung is demoted."""
        if name in kvcache.PAGED_KERNEL_IMPLS \
                and self._rung_demoted("prefill_cuda"):
            return "gather"
        return name

    def _select_prefill_kernel(self, S: int, occ: int):
        """This admission's chunk-attention backend (resolved) and, in auto
        mode with a VPE, its ``prefill_kernel`` bucket and selected name
        (else None, None): the ``prefill_chunk`` axis's key, fed from the
        same chunk costs."""
        if self.prefill_kernel != "auto":
            return self._resolve_kernel(self.prefill_kernel), None, None
        if self.vpe is None:
            return SERVE_AXES["prefill_kernel"][0], None, None
        bucket = prefill_chunk_bucket(S, occ, self.num_slots,
                                      levels=self.occupancy_levels)
        if self.slo_weight > 0:
            bucket = bucket + self._slo_bucket()
        bucket = bucket + self._shard_tail
        name = self._decide(
            lambda: self.vpe.controller.select("prefill_kernel", bucket))
        return self._resolve_kernel(name), bucket, name

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
            with span("serve.prefill_chunk"):
                self._run_one_chunk(i)
            ran = True
        if ran:
            self.stats.chunk_budget_hist[budget] = \
                self.stats.chunk_budget_hist.get(budget, 0) + 1
        return ran

    def _run_one_chunk(self, i: int) -> None:
        """One chunk of slot ``i``'s effective prompt, from ``fill_pos``
        (after a warm placement: the matched length, mid-block after a
        partial match; after a swap resume: the swapped-out fill); the
        final chunk yields the next token."""
        slot = self.slots[i]
        req = slot.req
        fault = self._take_fault("prefill")
        if fault is not None and fault.kind == "device":
            # the chunk call raised before its launch: nothing computed,
            # fill_pos unmoved.  The kernel backend takes the blame when it
            # ran (the demotion re-resolves this slot's next chunk);
            # otherwise the request is charged
            self.stats.device_faults += 1
            if slot.kernel in kvcache.PAGED_KERNEL_IMPLS:
                self._demote("prefill_cuda")
            elif self._charge_fault(req):
                self._fail_request(
                    req, "device_fault",
                    "injected device fault in prefill chunk", slot=i)
            else:
                self._preempt_slot(i)
            return
        prompt = req.effective_prompt()
        S = len(prompt)
        base = slot.fill_pos
        chunk = slot.chunk
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
        # the objective's second term: charge the chunk for the
        # class-weighted queue wait it imposed while it ran
        slot.chunk_costs.append(
            dt * (1.0 + self.slo_weight * self._queue_pressure()))
        self.stats.prefill_s += dt
        self.stats.prefill_chunks += 1
        if fault is not None:
            if fault.kind == "nan":
                # poisoned chunk logits: the K/V the chunk wrote is
                # untrusted too — quarantine the slot before fill_pos
                # counts the poisoned positions
                self._numeric_fault(i, "injected NaN logits in prefill chunk")
                return
            # stall: the chunk arrived late — keep it, count the trip
            if self.watchdog is not None:
                self.watchdog.trips += 1
            self.stats.watchdog_trips += 1
            slot.tainted = True
        slot.fill_pos = base + clen
        if slot.fill_pos >= S:
            self._finish_prefill(i, logits)

    def _finish_prefill(self, i: int, logits: torch.Tensor) -> None:
        """Last chunk done: the next token out, device length installed,
        the admission's samples fed (``prefix_reuse``: placement + chunk
        walls; ``prefill_chunk`` and ``prefill_kernel``: the chunk costs —
        no chunk call captures a graph, so none is dropped), and the
        prompt's fresh full blocks adopted into the prefix tree
        zero-copy."""
        slot = self.slots[i]
        req = slot.req
        first = self._first_token(i, logits)
        # a resumed residency prefilled its prompt and its earlier output
        self.cache["length"][i] = len(req.prompt) + len(req.out)
        slot.admit_wall = slot.place_wall + sum(slot.chunk_walls)
        if self.vpe is not None and not slot.tainted:
            if slot.reuse_bucket is not None:
                self.vpe.profiler.record("prefix_reuse", slot.reuse_variant,
                                         slot.reuse_bucket, slot.admit_wall)
                self.vpe.controller.on_sample("prefix_reuse",
                                              slot.reuse_bucket,
                                              slot.reuse_variant)
            if slot.chunk_bucket is not None:
                # the chunk size moves the chunk compute, not the placement
                self.vpe.profiler.record("prefill_chunk", slot.chunk_variant,
                                         slot.chunk_bucket,
                                         sum(slot.chunk_costs))
                self.vpe.controller.on_sample("prefill_chunk",
                                              slot.chunk_bucket,
                                              slot.chunk_variant)
            if slot.kernel_bucket is not None:
                self.vpe.profiler.record("prefill_kernel", slot.kernel_variant,
                                         slot.kernel_bucket,
                                         sum(slot.chunk_costs))
                self.vpe.controller.on_sample("prefill_kernel",
                                              slot.kernel_bucket,
                                              slot.kernel_variant)
        slot.reuse_bucket = None
        slot.chunk_bucket = None
        slot.kernel_bucket = None
        self._enter_decode(i, first)
        self._cache_extend(req, None, None, 0, slot)
        self._retire_if_done(i)

    def _cache_extend(self, req: Request, k_all, v_all, base: int,
                      slot: _Slot) -> None:
        """Insert the prompt's not-yet-cached full blocks into the tree.
        A paged slot hands its OWN pages to the tree (one more pool
        reference each, no device traffic); a contiguous slot copies its
        freshly computed K/V (``k_all``/``v_all`` cover positions ``[base,
        ...)``) into tree pages — paid only when a prefix is first seen."""
        if self.prefix_cache is None:
            return
        if slot.layout == "paged":
            self.prefix_cache.extend_adopt(
                req.cache_handle, req.prompt,
                {j: pid for j, pid in enumerate(slot.pages)})
            return
        fresh = self.prefix_cache.extend(req.cache_handle, req.prompt)
        if not fresh:
            return
        if self.pages is not None:
            # auto mode: the tree's pages are the unified pool's — one
            # masked scatter fills them all
            ids = torch.tensor([bid for bid, _ in fresh], dtype=torch.int64)
            starts = torch.tensor([st for _, st in fresh], dtype=torch.int64)
            kvcache.write_pages(self.page_pool, k_all, v_all, ids, starts,
                                base, len(req.prompt) - base)
        else:
            for bid, start in fresh:
                kvcache.write_block(self.block_pool, k_all, v_all, bid,
                                    start - base, self.block_size)
        # fence the page writes, or their device time leaks into the next
        # decode call's sample
        fence(self.device)

    def _enter_decode(self, i: int, first: int) -> None:
        """Emit the token a prefill gave and start decoding; the first
        token of a request records its TTFT (once: a resumed request's
        first token shipped in its first residency)."""
        slot = self.slots[i]
        req = slot.req
        if not req.ttft_recorded:
            req.ttft_s = time.perf_counter() - req.submit_t
            self.stats.ttft_s.append(req.ttft_s)
            if slot.layout == "paged":
                # a request preempted before its first token counts its
                # earlier residencies whole
                req.prefill_wait_s = max(
                    0.0, req.ttft_s - req.queue_wait_s - slot.place_wall
                    - sum(slot.chunk_walls))
            self.stats.prefill_wait_s.append(req.prefill_wait_s)
            req.ttft_recorded = True
        # positions in KV before this emission: prompt + earlier output
        eff_len = len(req.prompt) + len(req.out)
        req.out.append(first)
        if self.proposer is not None:
            # seed the slot's draft context from the prompt and what an
            # earlier residency emitted, then commit the first token: the
            # table learns the prompt before the first decode call
            self.proposer.observe_prompt(
                i, [int(t) for t in req.prompt] + req.out[:-1])
            self.proposer.observe(i, [first])
        self.stats.tokens_out += 1
        self.stats.prefill_tokens += 1
        slot.prefilling = False
        slot.tok = first
        slot.pos = eff_len
        slot.steps_resident = 0
        slot.clean_step_shares = []
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
            if slot.layout == "paged":
                self._release_slot_pages(i)
            if req.cache_handle is not None:
                # unpin: the matched and inserted blocks become evictable
                self.prefix_cache.release(req.cache_handle)
                req.cache_handle = None
            if slot.admit_bucket is not None and self.vpe is not None \
                    and not slot.tainted:
                # the kv_layout sample: admission wall + this request's
                # decode share from the calls that did not capture,
                # extrapolated over all its steps; a residency whose every
                # call captured has no clean signal and is dropped
                comp, ok = 0.0, True
                if slot.steps_resident:
                    if slot.clean_step_shares:
                        comp = (sum(slot.clean_step_shares)
                                / len(slot.clean_step_shares)
                                * slot.steps_resident)
                    else:
                        ok = False
                if ok:
                    self.vpe.profiler.record("kv_layout", slot.layout,
                                             slot.admit_bucket,
                                             slot.admit_wall + comp)
                    self.vpe.controller.on_sample("kv_layout",
                                                  slot.admit_bucket, slot.layout)
            slot.admit_bucket = None
            self.completed.append(req)
            slot.req = None   # freed mid-decode; refilled next admission
            if self.proposer is not None:
                self.proposer.forget_slot(i)
            self._masks_dirty = True

    # -- decode -------------------------------------------------------------
    def _grow_block_tables(self, span: int, remaining: Dict[int, int]) -> None:
        """Before a decode call: reserve, for every decoding paged slot,
        the pages covering its write range ``[pos, pos + min(span,
        remaining))`` — mid-horizon there is no host to allocate a page —
        and install every splice in ONE scatter, in place.  At ``span=1`` a
        page comes exactly when the next token starts a fresh block.  (A
        tail page is private — copy-on-write at placement — so appends need
        no copy.)

        Under pressure the allocation escalates (:meth:`_alloc_page`) and,
        when even that runs dry, the grower preempts itself; its request
        resumes exactly later.  A victim preempted in this loop may have
        grown earlier in it, so only the splices whose slot still owns the
        page are installed."""
        splices: List[Tuple[int, int, int]] = []
        for i, slot in enumerate(self.slots):
            if slot.free or slot.prefilling or slot.layout != "paged":
                continue
            upto = slot.pos + min(span, remaining[i])
            last_col = (upto - 1) // self.block_size
            assert last_col < self.nb_max, (last_col, self.nb_max)
            rank = PRIORITY_RANK[slot.req.priority]
            try:
                for col in range(len(slot.pages), last_col + 1):
                    pid = self._alloc_page(exclude=i, rank=rank,
                                           decode_growth=True)
                    slot.pages.append(pid)
                    splices.append((i, col, pid))
            except _PagePressure:
                # pages it took in this loop go back with the rest
                self._preempt_slot(i)
            except SimulatedFault as e:
                # an injected allocation fault mid-growth: nothing was
                # computed, so the request resumes by preemption or, its
                # budget spent, fails; its pages go back either way
                self.stats.device_faults += 1
                if self._charge_fault(slot.req):
                    self._fail_request(slot.req, "device_fault", str(e), slot=i)
                else:
                    self._preempt_slot(i)
        splices = [(i, col, pid) for (i, col, pid) in splices
                   if self.slots[i].req is not None
                   and col < len(self.slots[i].pages)
                   and self.slots[i].pages[col] == pid]
        if splices:
            idx = torch.tensor(splices, dtype=torch.int64).T.to(self.device)
            self.cache["bt"][idx[0], idx[1]] = idx[2].to(torch.int32)

    def _rollback_reserved(self, i: int) -> None:
        """Return a paged slot's reserved-but-unwritten horizon pages to
        the pool (a stop froze the slot before it reached them): the pages
        covering ``[0, pos)`` stay, every page past them goes back."""
        slot = self.slots[i]
        keep = -(-slot.pos // self.block_size)      # ceil
        while len(slot.pages) > keep:
            self.pages.unref(slot.pages.pop())
            self.stats.reserved_pages_rolled_back += 1

    def _refresh_device_masks(self) -> None:
        """Rewrite the tok, live, eos and paged rows of the device inputs
        from the host slot mirrors, in place and in one copy — only after
        an admission, prefill completion or retire dirtied them."""
        if not self._masks_dirty:
            return
        rows = np.array([
            [s.tok for s in self.slots],
            [0 if (s.free or s.prefilling) else 1 for s in self.slots],
            [-1 if (s.req is None or s.req.eos_id is None) else s.req.eos_id
             for s in self.slots],
            [1 if s.layout == "paged" else 0 for s in self.slots]], np.int32)
        self._inputs[:4].copy_(torch.from_numpy(rows))
        self._masks_dirty = False

    def _resolve_impl(self, name: str) -> str:
        """The decode variant that runs: the kernel variant is grouped on
        an engine without pages (the contiguous layout's rung) and while
        the ``decode_cuda`` rung is demoted."""
        if name in kvcache.PAGED_KERNEL_IMPLS and (
                self.pages is None or self._rung_demoted("decode_cuda")):
            return "grouped"
        return name

    def _select_decode_impl(self, bucket: Tuple) -> str:
        """The variant name this call records: a pinned name (resolved),
        or the controller's per-call selection, trials included — the
        eager analogue of the paper's patched function pointer."""
        if self.decode_impl != "auto":
            return self._resolve_impl(self.decode_impl)
        if self.vpe is not None:
            return self._decide(
                lambda: self.vpe.controller.select(self._axis, bucket))
        return SERVE_AXES[self._axis][0]

    def _select_horizon(self, n_active: int
                        ) -> Tuple[int, Optional[Tuple], Optional[str]]:
        """This step's decode horizon and, on the measured axis, its VPE
        bucket and variant name.  The bucket is keyed by the queue depth
        left after this step's admissions — the requests a fused horizon
        would delay — × occupancy.  While the ``horizon`` rung is demoted
        every step is a single step, a pinned horizon's too."""
        if self._rung_demoted("horizon"):
            return 1, None, None
        if self.decode_horizon != "auto":
            return int(self.decode_horizon), None, None
        if self.vpe is None:
            return 1, None, None
        bucket = decode_horizon_bucket(len(self.queue), n_active,
                                       self.num_slots,
                                       levels=self.occupancy_levels)
        if self.slo_weight > 0:
            # who waits matters too: an interactive waiter makes a long
            # fused call expensive under the two-term objective
            bucket = bucket + self._slo_bucket()
        bucket = bucket + self._shard_tail
        name = self._decide(
            lambda: self.vpe.controller.select("decode_horizon", bucket))
        return int(name), bucket, name

    def _decode(self, H: int, hbucket, hname,
                remaining: Dict[int, int], t_h: float) -> None:
        """One decode call of H steps (H = 1 is a single step, fault site
        ``decode``; H > 1 a fused horizon, site ``fused``): reserve every
        page the call can write (one block-table scatter), run the H steps
        on the device, fence once on the (slots, H) token block, commit
        each slot's valid tokens, roll its unused reserved pages back and
        retire it if it stopped.  Growth may preempt decoding slots (the
        grower itself included): they leave ``remaining``, and the masks
        are refreshed, before the budget row is written and the graph
        replays, so a victim replays with live 0 and budget 0.  A planned
        device fault skips the launch (a fused call's blames ``horizon``,
        a single step's the kernel variant when it would have run it); a
        poisoned slot commits nothing and is quarantined."""
        fused = H > 1
        fault = self._take_fault("fused" if fused else "decode")
        with span("serve.decode.prepare"):
            if self.pages is not None:
                self._grow_block_tables(span=H, remaining=remaining)
                remaining = {i: r for i, r in remaining.items()
                             if self.slots[i].req is not None
                             and not self.slots[i].prefilling}
                if not remaining:
                    return
            self._refresh_device_masks()
            if fused and fault is not None and fault.kind == "device":
                self._span_device_fault(
                    "horizon", list(remaining),
                    "injected device fault in fused horizon call")
                return
            bucket = occupancy_bucket(len(remaining), self.num_slots,
                                      levels=self.occupancy_levels) \
                + self._shard_tail
            name = self._select_decode_impl(bucket)
            impl = self._resolve_impl(name)
            if not fused and fault is not None and fault.kind == "device":
                # the kernel variant takes the blame only when it would have
                # run: grouped has no rung below it
                rung = ("decode_cuda" if impl in kvcache.PAGED_KERNEL_IMPLS
                        else None)
                self._span_device_fault(rung, list(remaining),
                                        "injected device fault in decode step")
                return
            budget = np.zeros((self.num_slots,), np.int32)
            for i, rem in remaining.items():
                budget[i] = rem
            self.graphs.budget.copy_(torch.from_numpy(budget))
        t0 = time.perf_counter()
        # greedy argmax on the device; only the (slots, H) token block and
        # valid mask cross to the host, and that copy is the call's fence
        with span("serve.decode.launch"):
            out, captured = self.graphs.launch(impl, H)
        host, tripped = self._guarded_fence(out, fault)
        dt = time.perf_counter() - t0
        with span("serve.decode.commit"):
            toks, emits = host[0], host[1]
            self.stats.decode_s += dt
            self.stats.decode_steps += H
            self.stats.horizon_hist[H] = self.stats.horizon_hist.get(H, 0) + 1
            if tripped:
                # the fence stalled: its tokens arrived and are committed, and
                # the variant that hung is demoted (a grouped single step has
                # nothing below it)
                if fused:
                    self._demote("horizon")
                elif impl in kvcache.PAGED_KERNEL_IMPLS:
                    self._demote("decode_cuda")
            if fault is not None and fault.kind == "nan":
                # poisoned logits: an out-of-vocab sentinel on the planned
                # slot's rows (all rows without one); the validation below
                # quarantines what a real NaN would hit
                toks = toks.copy()
                if fused:
                    rows = ([fault.slot] if fault.slot is not None
                            and fault.slot in remaining else list(remaining))
                    toks[rows, :] = -1
                elif fault.slot is not None:
                    toks[fault.slot, :] = -1
                else:
                    toks[:, :] = -1
            tainted = captured or tripped
            self.stats.tainted_steps += tainted
            valid_total = int(emits.sum())
            if fused:
                self.stats.horizon_calls += 1
                self.stats.horizon_tokens += valid_total
            if self.vpe is not None and not tainted:
                # the decode-attention axis keeps per-STEP units
                self.vpe.profiler.record(self._axis, name, bucket, dt / H)
                self.vpe.controller.on_sample(self._axis, bucket, name)
            share = dt / max(valid_total, 1)
            vocab = self.cfg.vocab_size
            quarantine: List[int] = []
            probe_off = probe_acc = 0
            self._probe_tick += 1
            probing = (self.spec_draft == "auto"
                       and self._probe_tick % self._probe_every == 0)
            for i in remaining:
                slot = self.slots[i]
                # a slot stops at most once, so its valid tokens are a prefix
                e = int(emits[i].sum())
                new_toks = [int(t) for t in toks[i, :e]]
                if any(t < 0 or t >= vocab for t in new_toks):
                    # garbage logits for this slot: nothing of the call is
                    # committed, and it is quarantined after the loop
                    quarantine.append(i)
                    continue
                slot.req.out.extend(new_toks)
                if self.proposer is not None:
                    if probing and new_toks:
                        # the counterfactual probe reads the context before
                        # observe() moves it
                        probe_acc += self._probe_accept(i, new_toks)
                        probe_off += len(new_toks)
                    self.proposer.observe(i, new_toks)
                slot.tok = new_toks[-1]
                slot.pos += e
                slot.steps_resident += e
                if not tainted:
                    slot.clean_step_shares.extend([share] * e)
                self.stats.tokens_out += e
                if slot.layout == "paged":
                    self._rollback_reserved(i)
                self._retire_if_done(i)
            for i in quarantine:
                self._numeric_fault(
                    i, "out-of-range token from "
                    + ("fused horizon call" if fused else "decode step"))
            self._update_accept_ema(probe_off, probe_acc)
            if fault is None and not tripped:
                self._tick_probation()
            if self.vpe is not None and not tainted and valid_total:
                # per-TOKEN wall of the whole span (reservation, call, fence,
                # commit — the host work a horizon amortizes); frozen steps
                # emit nothing, so an over-long horizon pays for itself here.
                # The SLO charge makes the same wall cost more while queued
                # (above all interactive) requests wait it out.  With the spec
                # axis live and "off" selected, this plain call is its off
                # variant, fed in the verify path's units.
                charge = 1.0 + self.slo_weight * self._queue_pressure()
                per_tok = (time.perf_counter() - t_h) / valid_total * charge
                if hbucket is not None:
                    self.vpe.profiler.record("decode_horizon", hname, hbucket,
                                             per_tok)
                    self.vpe.controller.on_sample("decode_horizon", hbucket,
                                                  hname)
                if self._spec_off_pending is not None:
                    sb, sn = self._spec_off_pending
                    self.vpe.profiler.record("spec_draft", sn, sb, per_tok)
                    self.vpe.controller.on_sample("spec_draft", sb, sn)

    # -- speculative decoding ------------------------------------------------
    def _select_spec(self, n_active: int
                     ) -> Tuple[int, Optional[Tuple], Optional[str]]:
        """This step's verify span (0 = off) and, on the measured axis, its
        VPE bucket and variant name.  Runs before the horizon is chosen: a
        step that speculates replaces the decode call, so the horizon axis
        sees no sample for it.  The bucket is the horizon axis's queue
        depth x occupancy and the engine's measured acceptance level."""
        if self._rung_demoted("spec") or self.spec_draft == "off":
            return 0, None, None
        if self.spec_draft != "auto":
            return int(self.spec_draft), None, None
        if self.vpe is None:
            return 0, None, None
        bucket = spec_accept_bucket(len(self.queue), n_active, self.num_slots,
                                    self._accept_ema,
                                    levels=self.occupancy_levels)
        if self.slo_weight > 0:
            bucket = bucket + self._slo_bucket()
        bucket = bucket + self._shard_tail
        name = self._decide(
            lambda: self.vpe.controller.select("spec_draft", bucket))
        return (0 if name == "off" else int(name)), bucket, name

    def _update_accept_ema(self, offered: int, accepted: int) -> None:
        # acceptance is a property of the traffic, not a timing: a capture
        # or a stall does not spoil it, so the EMA always moves
        if not offered:
            return
        frac = accepted / offered
        self._accept_ema = (frac if self._accept_ema is None
                            else 0.8 * self._accept_ema + 0.2 * frac)

    def _probe_accept(self, i: int, new_toks: List[int]) -> int:
        """How many of a plain call's committed tokens the proposer WOULD
        have drafted (the longest matching prefix, the verify's rule) —
        the acceptance signal stays live while the axis has selected
        ``off``, at no device cost and with no effect on the output."""
        drafts = self.proposer.draft(i, len(new_toks))
        e = 0
        while e < len(new_toks) and drafts[e] == new_toks[e]:
            e += 1
        return e

    def _spec_decode(self, S: int, sbucket, sname,
                     remaining: Dict[int, int], t_h: float) -> None:
        """One speculative verify call: reserve pages for the whole
        S-position span, draft S-1 tokens a decoding slot from the n-gram
        table, run the one-pass verify (a graph replay on the card), fence
        once, commit each slot's verified prefix, roll the rejected tail's
        pages back and retire stopped slots — :meth:`_decode`'s structure
        with the drafts as input and the acceptance counted."""
        fault = self._take_fault("spec")
        with span("serve.decode.prepare"):
            self._grow_block_tables(span=S, remaining=remaining)
            remaining = {i: r for i, r in remaining.items()
                         if self.slots[i].req is not None
                         and not self.slots[i].prefilling}
            if not remaining:
                return
            self._refresh_device_masks()
            if fault is not None and fault.kind == "device":
                self._span_device_fault(
                    "spec", list(remaining),
                    "injected device fault in speculative verify call")
                return
            # column 0 is each slot's last committed token (its score is the
            # token a plain step would emit), columns 1.. the drafts; a miss
            # pads with a wrong token, so speculation measures as a loss where
            # the table has nothing
            tokens = np.zeros((self.num_slots, S), np.int32)
            for i, slot in enumerate(self.slots):
                if slot.req is not None:
                    tokens[i, 0] = slot.tok
                if i in remaining:
                    tokens[i, 1:] = self.proposer.draft(i, S - 1)
            budget = np.zeros((self.num_slots,), np.int32)
            for i, rem in remaining.items():
                budget[i] = rem
            self.graphs.budget.copy_(torch.from_numpy(budget))
        t0 = time.perf_counter()
        with span("serve.decode.launch"):
            out, captured = self.graphs.verify(tokens)
        host, tripped = self._guarded_fence(out, fault)
        dt = time.perf_counter() - t0
        with span("serve.decode.commit"):
            toks, emits = host[0], host[1]
            self.stats.decode_s += dt
            self.stats.decode_steps += 1
            self.stats.spec_calls += 1
            if tripped:
                self._demote("spec")
            if fault is not None and fault.kind == "nan":
                toks = toks.copy()
                rows = ([fault.slot] if fault.slot is not None
                        and fault.slot in remaining else list(remaining))
                toks[rows, :] = -1
            tainted = captured or tripped
            self.stats.tainted_steps += tainted
            valid_total = int(emits.sum())
            share = dt / max(valid_total, 1)
            vocab = self.cfg.vocab_size
            quarantine: List[int] = []
            offered_total = accepted_total = 0
            for i in remaining:
                slot = self.slots[i]
                # the committed tokens are a prefix of the span
                e = int(emits[i].sum())
                new_toks = [int(t) for t in toks[i, :e]]
                if any(t < 0 or t >= vocab for t in new_toks):
                    quarantine.append(i)
                    continue
                # the drafts this slot's budget could still commit (k drafts
                # need k + 1 <= budget), and those that landed
                offered = min(S - 1, max(remaining[i] - 1, 0))
                acc = max(e - 1, 0)
                offered_total += offered
                accepted_total += acc
                self.stats.draft_tokens += offered
                self.stats.accepted_tokens += acc
                self.stats.accept_hist[acc] = \
                    self.stats.accept_hist.get(acc, 0) + 1
                slot.req.out.extend(new_toks)
                self.proposer.observe(i, new_toks)
                slot.tok = new_toks[-1]
                slot.pos += e
                slot.steps_resident += e
                if not tainted:
                    slot.clean_step_shares.extend([share] * e)
                self.stats.tokens_out += e
                if slot.layout == "paged":
                    self._rollback_reserved(i)
                self._retire_if_done(i)
            for i in quarantine:
                self._numeric_fault(
                    i, "out-of-range token from speculative verify call")
            self._update_accept_ema(offered_total, accepted_total)
            if fault is None and not tripped:
                self._tick_probation()
            if self.vpe is not None and sbucket is not None and not tainted \
                    and valid_total:
                # per-COMMITTED-token wall of the whole span (drafting,
                # reservation, call, fence, commit): drafts that miss commit
                # ~1 token a call and price the span out
                charge = 1.0 + self.slo_weight * self._queue_pressure()
                self.vpe.profiler.record("spec_draft", sname, sbucket,
                                         (time.perf_counter() - t_h)
                                         / valid_total * charge)
                self.vpe.controller.on_sample("spec_draft", sbucket, sname)

    def step(self) -> bool:
        """One engine iteration; returns False when fully idle.

        The deadline sweep, then admission and at most ``chunks_per_step``
        prefill chunks, then ONE decode call — a speculative verify when
        the spec axis or pin says so, else a decode call of H steps —
        advances the decoding slots: the wall between two decode calls is
        bounded by the chunk budget (``stats.decode_stall_s``) and the
        horizon.  A sharded rank runs the model under its shard scope."""
        if self.shards is None:
            return self._step()
        with shard_scope(self.shards):
            return self._step()

    def _step(self) -> bool:
        self._shed_expired()
        had_decoders = self.num_decoding > 0
        admits_before = len(self.stats.queue_wait_s)
        t_p = time.perf_counter()
        with span("serve.admit"):
            self._admit()
        ran_chunk = self._run_prefill_chunks()
        prefill_work = ran_chunk or len(self.stats.queue_wait_s) != admits_before
        n_active = self.num_decoding
        if n_active == 0:
            return prefill_work
        if had_decoders and prefill_work:
            self.stats.decode_stall_s.append(time.perf_counter() - t_p)
        # the horizon and spec axes' timed span starts here: it holds the
        # host work a fused call amortizes, not only the fenced device wall
        t_h = time.perf_counter()
        # tokens each decoding slot may still emit: the call's budget, and
        # the clamp of its span onto the DECLARED set — an arbitrary
        # clamped length would capture a new graph mid-serve
        remaining = {i: s.req.max_new_tokens - len(s.req.out)
                     for i, s in enumerate(self.slots)
                     if s.req is not None and not s.prefilling}
        cap = pad_to_bucket(max(remaining.values()), minimum=1)
        self._spec_off_pending = None
        S, sbucket, sname = self._select_spec(n_active)
        if S > 1:
            choices = (self.spec_choices if self.spec_draft == "auto"
                       else (int(self.spec_draft),))
            fit = [c for c in choices if c <= S and c <= cap]
            S = max(fit) if fit else 0
        if S > 1:
            with span("serve.decode"):
                self._spec_decode(S, sbucket, sname, remaining, t_h)
            return True
        if sbucket is not None:
            # the axis chose "off" (or the span clamped out): the plain
            # call below is its off variant
            self._spec_off_pending = (sbucket, sname)
        H, hbucket, hname = self._select_horizon(n_active)
        allowed = [1] + [c for c in
                         (self.horizon_choices
                          if self.decode_horizon == "auto" else (H,))
                         if c <= H]
        H = max(c for c in allowed if c <= cap)
        with span("serve.decode"):
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


def _merge_stats(parts: Sequence[ServeStats]) -> ServeStats:
    """Aggregate per-replica stats into one :class:`ServeStats` view:
    scalars sum, series concatenate, histograms merge by key."""
    out = ServeStats()
    for p in parts:
        for f in dataclasses.fields(ServeStats):
            mine, theirs = getattr(out, f.name), getattr(p, f.name)
            if isinstance(mine, list):
                mine.extend(theirs)
            elif isinstance(mine, dict):
                for k, v in theirs.items():
                    mine[k] = mine.get(k, 0) + v
            else:
                setattr(out, f.name, mine + theirs)
    return out


def _mesh_device_list(dp: int, mp: int,
                      mesh_devices: Optional[Sequence[DeviceLike]]
                      ) -> List[torch.device]:
    """The dp·mp torch devices of a mesh, row-major: ``mesh_devices``
    resolved, or ``cuda:0 … cuda:{dp·mp−1}`` by default.  Raises when the
    default needs more cards than are visible, or when a named card does
    not exist — never a silent move to another device."""
    need = dp * mp
    if mesh_devices is None:
        visible = torch.cuda.device_count()
        if visible < need:
            raise ValueError(
                f"mesh ({dp},{mp}) needs {need} devices, only {visible} "
                f"visible (name them with mesh_devices; one device may be "
                f"named more than once, e.g. ['cuda:0', 'cuda:0'] or "
                f"['cpu', 'cpu'])")
        mesh_devices = [f"cuda:{i}" for i in range(need)]
    if len(mesh_devices) != need:
        raise ValueError(f"mesh ({dp},{mp}) needs {need} devices, "
                         f"mesh_devices names {len(mesh_devices)}")
    devs = []
    for d in mesh_devices:
        dev = resolve_device(d)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0 if dev.index is None else dev.index)
            if dev.index >= torch.cuda.device_count():
                raise ValueError(f"mesh device {dev} is not visible "
                                 f"({torch.cuda.device_count()} cards)")
        devs.append(dev)
    return devs


def _on_device(dev: torch.device):
    """Make ``dev`` the current card while a replica builds or steps (its
    kernels, graphs and streams then land there); nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class EngineReplicaGroup:
    """``dp`` independent engine replicas sharing one admission queue.

    The mesh's ``dp`` axis is *replica* parallelism: each replica is a
    full :class:`ContinuousBatchingEngine` with its own slot pool, KV
    storage, page pool and decode graphs on its own device row — replicas
    never exchange activations, so the whole group is plain in-process
    objects (no RPC, no collective across ``dp``).  What they DO share is
    admission: one group-level queue feeds whichever replica has free
    capacity, so a burst lands on idle replicas instead of queueing
    behind a busy one.

    Placement: ``mesh_devices`` lists the dp·mp torch devices, row-major
    (default ``cuda:0 … cuda:{dp·mp−1}``; the constructor raises when
    fewer cards are visible).  One device may be named more than once:
    that is how two replicas share one card, or the CPU.  Replicas on the
    device that holds ``params`` share its tensors (serving never writes
    them); a replica elsewhere gets a copy, one per device.  Each replica
    builds and launches its kernels in its constructor and captures its
    own decode and verify graphs, as a single engine does.

    Dispatch semantics (:meth:`step`): while the shared queue is
    non-empty and some replica has a free slot, the best-priority (then
    oldest) queued request moves to the least-loaded replica.  Requests
    are committed to a replica only when it can actually admit them —
    early binding would recreate per-replica head-of-line blocking, which
    is the thing a shared queue exists to avoid.  Prefix affinity and
    starvation bounds then apply *within* the replica exactly as on a
    single engine.

    Every replica is constructed with the full ``(dp, mp)``
    ``shard_dims``, so all replicas' dispatch keys carry the same shard
    segment and a shared ``vpe`` learns ONE policy per mesh configuration
    from every replica's samples.

    **Head sharding** (``mp > 1``): the process of rank r holds shard r of
    every replica, on column r of ``mesh_devices``, and one
    ``shard_group`` serves all replicas, since they step in the same order
    on every rank.  Every rank builds the same group and is handed the
    same submissions; the group's deadline reads go through rank 0, as the
    engine's decisions do, so its quarantine and canary verdicts (which
    read only the replicas' agreed counters) are the same on every rank.
    Each replica keeps its own copy of its shard.  A real CUDA error on
    one rank is fatal to the whole group: the other ranks would block in
    their next collective.

    **Failover.**  The group is the recovery rung ABOVE the engine's
    degradation ladder: a replica that keeps producing fault evidence
    (terminal device/numeric step faults, watchdog fence trips, dispatch
    losses) past ``replica_fault_budget`` since its last clean window is
    quarantined — its resident requests are preempted (exact greedy
    resume via ``effective_prompt``) and its queue drained back to the
    shared queue at class head, so survivors rerun identically on healthy
    replicas.  A quarantined replica is probed with canary requests
    (synthetic, excluded from :attr:`completed`); one clean canary run
    re-admits it and resets its evidence base.  A single shared
    :class:`FaultPlan` drives the whole group — replicas consume sites in
    deterministic step order, so group chaos runs replay exactly."""

    def __init__(self, cfg: ModelConfig, params: Any, *, dp: int, mp: int,
                 mesh_devices: Optional[Sequence[DeviceLike]] = None,
                 replica_fault_budget: int = 3,
                 **engine_kwargs: Any) -> None:
        if dp < 2:
            raise ValueError("EngineReplicaGroup needs dp >= 2 "
                             "(a single replica is just the engine)")
        if replica_fault_budget < 1:
            raise ValueError("replica_fault_budget must be >= 1")
        if "device" in engine_kwargs:
            raise ValueError("a replica group places its replicas by "
                             "mesh_devices, not device")
        devs = _mesh_device_list(dp, mp, mesh_devices)
        self.mesh_shape = (dp, mp)
        self.shard_group: Optional[ShardGroup] = engine_kwargs.get("shard_group")
        rank = self.shard_group.rank if mp > 1 and self.shard_group else 0
        self.queue: List[Request] = []
        self._failed: List[Request] = []
        self._stats = ServeStats()   # group-level failures + failover events
        # the plan is SHARED with every replica (not copied): sites are
        # consumed in group-step order, one deterministic schedule.  The
        # admission bound guards the SHARED queue; replica-local queues
        # are dispatch buffers bounded by free slots, so the engines get
        # no depth bound of their own.
        self.faults: Optional[FaultPlan] = engine_kwargs.get("fault_plan")
        self.max_queue_depth: Optional[int] = \
            engine_kwargs.pop("max_queue_depth", None)
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        self.max_request_faults: int = \
            engine_kwargs.get("max_request_faults", 3)
        self.replica_fault_budget = replica_fault_budget
        home = params["embed"].device
        copies: Dict[torch.device, Any] = {}
        self.engines: List[ContinuousBatchingEngine] = []
        for r in range(dp):
            row = devs[r * mp:(r + 1) * mp]
            dev = row[rank]
            if dev not in copies:
                copies[dev] = (params if home == dev else
                               pytree.tree_map(lambda t: t.to(dev), params))
            with _on_device(dev):
                self.engines.append(ContinuousBatchingEngine(
                    cfg, copies[dev], mesh_shape=(1, mp), mesh_devices=row,
                    shard_dims=(dp, mp), **engine_kwargs))
        self.max_len = self.engines[0].max_len
        self.quarantined: set = set()
        # per-replica evidence floor: fault evidence BELOW the floor was
        # already acted on (a quarantine or a clean canary resets it)
        self._ev_base = [0] * dp
        self._dispatch_faults = [0] * dp
        # replica -> (in-flight canary, evidence snapshot at launch)
        self._canary: Dict[int, Tuple[Request, int]] = {}
        self._canary_seq = 0
        self._deadlines_live = False

    # -- request intake ----------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue on the SHARED queue — or terminally fail, with the
        same taxonomy as the single engine (reason code + detail)."""
        req.submit_t = time.perf_counter()
        if self.mesh_shape[1] > 1:
            req.submit_t = _agree_request(self.shard_group, req, req.submit_t)
        err = _intake_error(req, self.max_len)
        if err is not None:
            self._fail(req, "intake", err)
            return
        if self.max_queue_depth is not None \
                and len(self.queue) >= self.max_queue_depth:
            self._fail(
                req, "capacity",
                f"queue depth {len(self.queue)} at admission bound "
                f"{self.max_queue_depth}")
            return
        if req.deadline_s is not None:
            self._deadlines_live = True
        req.status = "queued"
        self.queue.append(req)

    def _fail(self, req: Request, reason: str, detail: str) -> None:
        """Group-side terminal failure — same accounting contract as the
        engine's ``_fail_request`` for a request not resident anywhere:
        reason code, detail, ``done_t``, and a terminal queue wait when
        it was never admitted by any replica."""
        assert reason in FAIL_REASONS, reason
        req.swap = None
        req.error = reason
        req.error_detail = detail
        req.status = "failed"
        req.done = True
        req.done_t = time.perf_counter()
        if req.admit_step < 0:
            req.queue_wait_s = req.done_t - req.submit_t
            self._stats.rejected += 1
        self._stats.failed_by_reason[reason] = \
            self._stats.failed_by_reason.get(reason, 0) + 1
        self._failed.append(req)

    # -- replica failover ---------------------------------------------------
    def _evidence(self, r: int) -> int:
        """Cumulative fault evidence against replica *r*: step-level
        faults its own ladder absorbed or failed on, watchdog fence
        trips, and dispatch losses."""
        s = self.engines[r].stats
        return (s.device_faults + s.numeric_faults + s.watchdog_trips
                + self._dispatch_faults[r])

    def _quarantine_replica(self, r: int) -> None:
        """Pull replica *r* out of dispatch and migrate its work.

        Resident requests are preempted with swap DISABLED — a host swap
        image from a faulting replica is exactly as untrusted as its KV —
        and, with everything the replica had queued, drained back to the
        shared queue at class head (``_requeue`` ordering: ahead of their
        own class, behind better classes).  Greedy parity makes the rerun
        on a survivor token-exact.  Each migrated request is charged one
        fault so a request that keeps landing on dying replicas
        terminates as ``replica_lost`` instead of migrating forever."""
        eng = self.engines[r]
        self.quarantined.add(r)
        self._stats.replica_quarantines += 1
        swap_save, eng.swap = eng.swap, False
        try:
            for i, s in enumerate(eng.slots):
                if s.req is not None:
                    eng._preempt_slot(i)
        finally:
            eng.swap = swap_save
        migrated = [q for q in eng.queue if not q.canary]
        eng.queue = [q for q in eng.queue if q.canary]
        for req in migrated:
            req.faults += 1
            if req.faults >= self.max_request_faults:
                self._fail(
                    req, "replica_lost",
                    f"fault budget spent migrating off replica {r}")
            else:
                req.status = "queued"
                self._requeue_shared(req)

    def _requeue_shared(self, req: Request) -> None:
        """Class-head insert into the SHARED queue (the group analogue of
        the engine's ``_requeue``)."""
        rank = PRIORITY_RANK[req.priority]
        pos = next((j for j, r in enumerate(self.queue)
                    if PRIORITY_RANK[r.priority] >= rank), len(self.queue))
        self.queue.insert(pos, req)

    def _check_replicas(self) -> None:
        for r in range(len(self.engines)):
            if r not in self.quarantined \
                    and self._evidence(r) - self._ev_base[r] \
                    >= self.replica_fault_budget:
                self._quarantine_replica(r)

    def _probe_quarantined(self) -> None:
        """Canary lifecycle: every quarantined replica always has one
        probe in flight.  A canary that completes ``ok`` with NO new fault
        evidence since launch re-admits the replica (evidence base reset —
        it starts its next budget window clean); a canary that fails or
        trips anything leaves the replica quarantined and a fresh probe
        launches next group step."""
        for r in sorted(self.quarantined):
            eng = self.engines[r]
            probe = self._canary.get(r)
            if probe is None:
                self._canary_seq -= 1
                can = Request(
                    rid=self._canary_seq,
                    prompt=np.arange(1, 9, dtype=np.int32),
                    max_new_tokens=4,
                    priority="interactive",
                    canary=True)
                self._canary[r] = (can, self._evidence(r))
                self._stats.canary_probes += 1
                eng.submit(can)
                continue
            can, ev0 = probe
            if not can.done:
                continue
            del self._canary[r]
            if can.status == "done" and self._evidence(r) == ev0:
                self.quarantined.discard(r)
                self._ev_base[r] = self._evidence(r)
                self._stats.replica_readmissions += 1

    def _shed_expired(self) -> None:
        """Deadline sweep over the SHARED queue (replicas sweep their own
        queues and slots in their step)."""
        if not self._deadlines_live:
            return
        now = self.engines[0]._now()

        def _expired(q: Request) -> bool:
            return (q.deadline_s is not None
                    and now - q.submit_t > q.deadline_s)

        expired = [q for q in self.queue if _expired(q)]
        if expired:
            self.queue = [q for q in self.queue if not _expired(q)]
            for q in expired:
                self._fail(
                    q, "deadline",
                    f"expired in shared queue after {now - q.submit_t:.3f}s "
                    f"(deadline {q.deadline_s:.3f}s)")

    def _dispatch(self) -> None:
        """Move queued requests onto replicas with free capacity: best
        priority class first (FIFO within a class), least-loaded replica
        first.  Appends to the replica's queue directly — validation and
        ``submit_t`` already happened at group intake, and the replica's
        own scheduler handles it from here.

        Capacity is free slots MINUS requests already parked on the
        replica's local queue: dispatched-but-not-yet-admitted requests
        hold their claim, otherwise every tie-break in one dispatch pass
        would land on the same replica and a burst would serialize behind
        it — exactly the head-of-line blocking the shared queue exists to
        avoid.  Quarantined replicas take no dispatch; a ``dispatch``-site
        fault loses the handoff (the request stays in the shared queue,
        charged one fault) and counts as evidence against the target
        replica."""
        while self.queue:
            cap = [(sum(1 for s in e.slots if s.free) - len(e.queue), -r)
                   for r, e in enumerate(self.engines)
                   if r not in self.quarantined]
            if not cap:
                return              # every replica quarantined
            n_free, neg_r = max(cap)
            if n_free <= 0:
                return
            j = min(range(len(self.queue)),
                    key=lambda i: (PRIORITY_RANK[self.queue[i].priority], i))
            fault = (self.faults.take("dispatch")
                     if self.faults is not None else None)
            if fault is not None:
                req = self.queue[j]
                self._dispatch_faults[-neg_r] += 1
                req.faults += 1
                if req.faults >= self.max_request_faults:
                    self.queue.pop(j)
                    self._fail(req, "replica_lost",
                               "fault budget spent on lost dispatches")
                return              # retry the handoff next group step
            self.engines[-neg_r].queue.append(self.queue.pop(j))

    # -- engine surface ----------------------------------------------------
    def step(self) -> bool:
        """One group iteration: shed expired, dispatch, step every replica
        that has work (one after the other, each on its own device),
        evaluate replica health, run the canary lifecycle.  Returns False
        when the whole group is idle."""
        self._shed_expired()
        self._probe_quarantined()
        self._dispatch()
        progress = False
        for eng in self.engines:
            if eng.queue or eng.num_active > 0:
                with _on_device(eng.device):
                    progress = eng.step() or progress
        self._check_replicas()
        self._probe_quarantined()
        return progress or bool(self.queue)

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drain the shared queue and every replica; returns completed
        requests (failures included), exactly like the engine's.  A
        quarantined replica keeps the loop alive until its canary
        re-admits it, so a drained group ends healthy."""
        steps = 0
        while self.queue or self.quarantined \
                or any(e.queue or e.num_active > 0 for e in self.engines):
            if not self.step():
                break
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.completed

    def check_kv(self) -> None:
        """Page audit on every replica (replicas share no pages, so the
        group audit is the conjunction of the per-replica audits)."""
        for eng in self.engines:
            eng.check_kv()

    @property
    def num_active(self) -> int:
        return sum(e.num_active for e in self.engines)

    @property
    def completed(self) -> List[Request]:
        out: List[Request] = list(self._failed)
        for eng in self.engines:
            out.extend(r for r in eng.completed if not r.canary)
        return out

    @property
    def stats(self) -> ServeStats:
        """Aggregated view: per-replica stats merged plus group-level
        intake rejections and failover events.  Recomputed per access —
        cheap at serving scale, always consistent."""
        return _merge_stats([self._stats] + [e.stats for e in self.engines])


def make_serve_engine(cfg: ModelConfig, params: Any, *,
                      mesh_shape: Tuple[int, int] = (1, 1),
                      mesh_devices: Optional[Sequence[DeviceLike]] = None,
                      **engine_kwargs: Any):
    """Build the serve engine for a ``(dp, mp)`` mesh shape.

    ``dp == 1`` returns a plain :class:`ContinuousBatchingEngine` (the
    single-device engine at ``(1, 1)``, its dispatch keys unchanged);
    ``dp > 1`` returns an :class:`EngineReplicaGroup` of dp engines on
    ``mesh_devices`` behind one shared admission queue.  ``mp > 1`` shards
    each engine's heads over mp processes: call this on every rank with
    the rank's ``shard_group`` (``spawn_ranks`` runs a function on each;
    ``mesh_devices`` defaults to ``cuda:0 … cuda:{dp·mp−1}``, and one
    device may repeat: ``["cpu"] * 2``, ``["cuda:0"] * 2``).  Both expose
    the same serve surface (``submit`` / ``step`` / ``run`` / ``check_kv`` /
    ``num_active`` / ``completed`` / ``stats``)."""
    dp, mp = (int(mesh_shape[0]), int(mesh_shape[1]))
    if dp <= 1 and mp > 1:
        mesh_devices = _mesh_device_list(1, mp, mesh_devices)
    if dp <= 1:
        return ContinuousBatchingEngine(cfg, params, mesh_shape=(1, mp),
                                        mesh_devices=mesh_devices,
                                        **engine_kwargs)
    return EngineReplicaGroup(cfg, params, dp=dp, mp=mp,
                              mesh_devices=mesh_devices, **engine_kwargs)
