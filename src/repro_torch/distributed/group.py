"""One process a shard: the process group of a head-sharded serve engine.

The reference shards a serve replica over its ``mp`` devices inside one
JAX process, and XLA inserts the collectives GSPMD derives.  The port runs
one process a rank instead, each holding its slice of the heads, the FFN
hidden dim and the experts (:mod:`repro_torch.distributed.sharding`), and
running the same forward code over it; one all-reduce after each
down-projection completes the sum (:func:`project_out` and
:func:`reduce_partial`, which the model calls where a :func:`shard_scope`
is active).  A rank's partial is computed and summed in f32 and rounded
once, as the whole product is on one device.

* :class:`ShardGroup` — the rank, the world size, the backend, an in-place
  sum and :meth:`~ShardGroup.agree` (rank 0's value on every rank);
* :func:`init_shard_group` — the process group of one rank, from an
  address the caller gives (nothing on the machine names a cluster);
* :func:`shard_backend` — ``"nccl"`` when a row's devices are distinct CUDA
  cards, ``"gloo"`` otherwise (CPU ranks, or ranks that share one card,
  which NCCL refuses); chosen from the placement, never by catching an
  error;
* :func:`spawn_ranks` — runs a function on every rank, each in a process
  started with the ``spawn`` method, over a ``file://`` store in a
  temporary directory (no port to pick, so parallel callers never meet),
  and returns each rank's result.

A rank that fails takes the group down: the others would block in their
next collective, so :func:`spawn_ranks` terminates them and raises with
the failed rank's traceback.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import ShardPlan

DEFAULT_TIMEOUT_S = 600.0


class ShardGroup:
    """The ranks of one head-sharded engine (or of every replica of a
    group, which step in the same order on every rank)."""

    def __init__(self, rank: int, world: int, backend: str) -> None:
        self.rank = rank
        self.world = world
        self.backend = backend

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns ``x``."""
        dist.all_reduce(x)
        return x

    def agree(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank (what every other rank passes is
        ignored)."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, by rank, on every rank."""
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def close(self) -> None:
        dist.barrier()
        dist.destroy_process_group()


def init_shard_group(rank: int, world: int, init_method: str,
                     backend: str = "gloo",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> ShardGroup:
    """Join the process group of ``world`` ranks at ``init_method``
    (``"file:///…"`` or ``"tcp://localhost:<port>"``) as ``rank``.  A
    collective that waits longer than ``timeout_s`` raises."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return ShardGroup(rank, world, backend)


def shard_backend(devices: Sequence[Any]) -> str:
    """``"nccl"`` when ``devices`` (one a rank) are distinct CUDA cards, else
    ``"gloo"``."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs):
        cards = [0 if d.index is None else d.index for d in devs]
        if len(set(cards)) == len(cards):
            return "nccl"
    return "gloo"


# -- the model's view: the scope a sharded engine sets around its steps -----------

@dataclasses.dataclass(frozen=True)
class ShardScope:
    group: ShardGroup
    plan: ShardPlan


_SCOPE: contextvars.ContextVar[Optional[ShardScope]] = contextvars.ContextVar(
    "repro_torch_shard_scope", default=None)


@contextlib.contextmanager
def shard_scope(scope: Optional[ShardScope]) -> Iterator[None]:
    """Run the model over a rank's shard while the block is active (None:
    no sharding, the code path of one device)."""
    token = _SCOPE.set(scope)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def active_scope() -> Optional[ShardScope]:
    return _SCOPE.get()


def splits(block: str) -> bool:
    """Whether the active plan splits ``block``: the ``"attn"`` output
    projection or the ``"ffn"`` (dense or MoE) down projection."""
    scope = _SCOPE.get()
    return scope is not None and bool(getattr(scope.plan, block))


def reduce_partial(x: torch.Tensor, block: str) -> torch.Tensor:
    """Complete a down-projection's partial sum over the ranks when the
    active plan splits ``block``.  A partial in a narrower type is summed
    in f32 and cast back once.  Without a scope, or for a replicated
    block, ``x`` as it is."""
    if not splits(block):
        return x
    group = _SCOPE.get().group
    if x.dtype == torch.float32:
        return group.all_reduce_(x)
    return group.all_reduce_(x.float()).to(x.dtype)


def f32_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` (``h`` (..., K), ``w`` (K, N)) accumulated and returned in
    f32, not rounded to the operands' narrower type: on a card the GEMM
    with an f32 output, on the CPU (which has none) the product of the
    upcast operands."""
    if h.dtype == torch.float32:
        return h @ w
    if h.is_cuda:
        return torch.mm(h.reshape(-1, h.shape[-1]), w, out_dtype=torch.float32
                        ).reshape(*h.shape[:-1], w.shape[-1])
    return h.float() @ w.float()


def project_out(h: torch.Tensor, w: torch.Tensor, block: str) -> torch.Tensor:
    """``h @ w``, the down-projection of ``block``.  Where the active plan
    splits it, the rank's partial over its slice of the contracted dim is
    kept in f32 (:func:`f32_product`), summed over the ranks and rounded
    once to ``h``'s type, as the whole product is on one device."""
    if not splits(block):
        return h @ w
    return reduce_partial(f32_product(h, w), block).to(h.dtype)


# -- running every rank ----------------------------------------------------------

def _rank_main(rank: int, world: int, init_method: str, backend: str,
               device: str, fn: Callable, args: tuple, results) -> None:
    """A rank's process: join the group, run ``fn(group, *args)``, post
    (rank, ok, result or traceback)."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # ranks on the CPU share its cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        group = init_shard_group(rank, world, init_method, backend)
        value = fn(group, *args)
        # a failed rank skips the closing barrier: the parent terminates
        # the ranks that wait in a collective for it
        group.close()
        results.put((rank, True, value))
    except Exception:     # the process's boundary: report, then exit
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, devices: Sequence[Any], args: tuple = (), *,
                backend: Optional[str] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(group, *args)`` on ``len(devices)`` ranks, rank r in a
    process of its own whose current device is ``devices[r]``, and return
    the results by rank.  ``fn`` and ``args`` are pickled (``fn`` by its
    import path).  ``backend`` defaults to :func:`shard_backend` of the
    devices.  Raises ``RuntimeError`` with the traceback of the first
    rank that failed (the others are terminated), or when no result came
    within ``timeout_s``."""
    import torch.multiprocessing as tmp

    devices = [str(torch.device(d)) for d in devices]
    world = len(devices)
    backend = backend or shard_backend(devices)
    ctx = tmp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="shard-store-") as store:
        init = f"file://{os.path.join(store, 'rendezvous')}"
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init, backend, devices[r], fn, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: List[Any] = [None] * world
        pending = set(range(world))
        failure: Optional[str] = None
        deadline = time.monotonic() + timeout_s
        try:
            while pending and failure is None:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r in pending
                            if procs[r].exitcode not in (None, 0)]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} before its result")
                    elif time.monotonic() > deadline:
                        failure = f"no result from ranks {sorted(pending)} in {timeout_s} s"
                    continue
                pending.discard(rank)
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return out
