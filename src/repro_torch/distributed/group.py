"""One process a shard: the process group of a head-sharded serve engine
and of a training mesh.

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
  and returns each rank's result;
* :class:`MeshGroups` — a rank's place on a
  ``(dp, mp)`` training grid: rank ``r`` is at ``(d, m) = divmod(r, mp)``,
  the reference's ``reshape(dp, mp)`` order, with a data subgroup (the
  ranks of its ``m``) and a model subgroup (the ranks of its ``d``);
* :func:`split_sum` — a row's sum over channels that the ranks split
  (RWKV6's ``ln_x``, Mamba2's gated norm: whole-row RMSNorms), summed over
  the model group forward and backward;
* :func:`gather_leaf` / :func:`gather_params` — fsdp: a leaf cut over the
  data group is all-gathered where the model reads it, one layer at a
  time (inside the recomputed function under remat, so the whole weight
  is not saved for backward and the recomputation gathers again, as XLA
  does inside the scan body); its backward reduce-scatters the f32
  gradient and divides by ``dp``, rounding once to the leaf's type: the
  data mean of that slice, the numbers of ``MeshGroups.data_mean_`` on a
  replicated leaf.

Training differentiates through the sums.  Megatron's pair of
collectives does it: :func:`enter_split` at each column-parallel input
is the identity forward and sums the gradient over the model group
backward (each rank's slice of heads or columns gives a partial of the
input's gradient); the row-parallel output (:func:`reduce_partial`) sums
forward and is the identity backward (every rank's upstream gradient is
already the whole one).  ``torch.distributed.nn.functional.all_reduce``
is not the latter: it sums the gradient too, multiplying it by ``mp``.
Serving runs the same two under ``no_grad``, where each is its forward.

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
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import ShardPlan

DEFAULT_TIMEOUT_S = 600.0
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class ShardGroup:
    """The ranks of one head-sharded engine (or of every replica of a
    group, which step in the same order on every rank)."""

    def __init__(self, rank: int, world: int, backend: str) -> None:
        self.rank = rank
        self.world = world
        self.backend = backend

    def all_reduce_(self, x: torch.Tensor, group: Any = None,
                    op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` over the ranks of ``group`` (a subgroup; None: every
        rank) by ``op`` (``"sum"`` or ``"max"``), in place; returns ``x``."""
        dist.all_reduce(x, op=_OPS[op], group=group)
        return x

    def all_gather_(self, parts: List[torch.Tensor], x: torch.Tensor,
                    group: Any = None) -> List[torch.Tensor]:
        """Every rank's ``x`` of ``group`` into ``parts`` (by rank in the
        group); returns ``parts``."""
        dist.all_gather(parts, x, group=group)
        return parts

    def reduce_scatter_(self, out: torch.Tensor, parts: List[torch.Tensor],
                        group: Any = None) -> torch.Tensor:
        """``out`` = the sum over the ranks of ``group`` of their
        ``parts[i]``, ``i`` this rank's index in the group; returns
        ``out``."""
        dist.reduce_scatter(out, parts, group=group)
        return out

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


class MeshGroups:
    """A rank's place on a ``(dp, mp)`` training grid of ``dp * mp`` ranks.

    ``group`` is every rank's; rank ``r`` sits at ``(d, m) = divmod(r,
    mp)``.  ``data`` is the subgroup of the ranks at this ``m`` (over which
    gradients are averaged), ``model`` the one at this ``d`` (over which a
    split layer's partial sums are completed); both are None where the
    axis has one rank, so no collective runs over it.  Every rank builds
    every subgroup, in the same order (``dist.new_group`` is collective;
    ``new_group`` stands in for it where no process group exists, as in
    the dry run's counting group)."""

    def __init__(self, group: ShardGroup, dp: int, mp: int, *,
                 new_group: Callable[[List[int]], Any] = dist.new_group) -> None:
        if group.world != dp * mp:
            raise ValueError(f"a ({dp}, {mp}) mesh needs {dp * mp} ranks, "
                             f"the group has {group.world}")
        self.group, self.dp, self.mp = group, dp, mp
        self.d, self.m = divmod(group.rank, mp)
        data = [new_group([d * mp + m for d in range(dp)]) if dp > 1 else None
                for m in range(mp)]
        model = [new_group([d * mp + m for m in range(mp)]) if mp > 1 else None
                 for d in range(dp)]
        self.data, self.model = data[self.m], model[self.d]

    def data_mean_(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` (f32) over the data group, in place.  The sum is
        divided by ``dp`` as a tensor on ``x``'s device: a Python number
        makes PyTorch's CUDA kernel multiply by its rounded reciprocal, one
        ulp off the CPU's quotient where ``dp`` is no power of two."""
        if self.dp > 1:
            self.group.all_reduce_(x, group=self.data).div_(
                torch.full((), self.dp, dtype=x.dtype, device=x.device))
        return x

    def data_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data group, in place."""
        if self.dp > 1:
            self.group.all_reduce_(x, group=self.data)
        return x

    def model_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the model group, in place."""
        if self.mp > 1:
            self.group.all_reduce_(x, group=self.model)
        return x


# -- the model's view: the scope a sharded engine sets around its steps -----------

@dataclasses.dataclass(frozen=True)
class ShardScope:
    """What the model needs of a rank's split: its process group, the plan,
    the model subgroup its partial sums run over (None: every rank of
    ``group``, as on a serve engine) and its index ``m`` in that subgroup
    (None: ``group.rank``); under fsdp the data subgroup of ``dp`` ranks
    and ``fsdp``, the dim (counted from the end) over which each leaf cut
    over it is gathered, by key string (``"['embed']"``,
    ``"['layers']['attn_wq']"``; a layer's leaf shares its stack's key)."""
    group: ShardGroup
    plan: ShardPlan
    model: Any = None
    m: Optional[int] = None
    data: Any = None
    dp: int = 1
    fsdp: Optional[Mapping[str, int]] = None

    @property
    def index(self) -> int:
        return self.group.rank if self.m is None else self.m


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


def keep_scope(fn: Callable) -> Callable:
    """``fn``, run under the scope active now wherever it is called later.
    A recomputation under remat runs in the backward pass, which for CUDA
    tensors runs in the autograd engine's thread, where this thread's
    scope is not set: without it the recomputed layer would run unsplit
    and its saved tensors would not match the forward's."""
    scope = _SCOPE.get()
    if scope is None:
        return fn

    def run(*args, **kwargs):
        with shard_scope(scope):
            return fn(*args, **kwargs)
    return run


def splits(block: str) -> bool:
    """Whether the active plan splits ``block``: the ``"attn"`` output
    projection, the ``"ffn"`` (dense, MoE, RWKV6's channel-mix, the GELU
    MLP) down projection, or the recurrent ``"mixer"`` (RWKV6's time-mix,
    Mamba2)."""
    scope = _SCOPE.get()
    return scope is not None and bool(getattr(scope.plan, block))


class _GatherData(torch.autograd.Function):
    """fsdp: every data rank's slice of a leaf gathered along ``dim``
    forward; backward, the gradient's f32 partials reduce-scattered back
    to the slices and divided by ``dp`` (rounded once to the leaf's
    type)."""

    @staticmethod
    def forward(ctx, x, scope, dim):
        ctx.scope, ctx.dim = scope, dim
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(scope.dp)]
        return torch.cat(scope.group.all_gather_(parts, x, group=scope.data), dim)

    @staticmethod
    def backward(ctx, g):
        scope = ctx.scope
        parts = [p.contiguous() for p in g.float().chunk(scope.dp, ctx.dim)]
        out = torch.empty_like(parts[0])
        scope.group.reduce_scatter_(out, parts, group=scope.data)
        # divided by a device tensor, as MeshGroups.data_mean_ divides
        dp = torch.full((), scope.dp, dtype=out.dtype, device=out.device)
        return out.div_(dp).to(g.dtype), None, None


def gather_leaf(x: torch.Tensor, key: str) -> torch.Tensor:
    """The rank's model shard of the leaf at ``key`` from the data group's
    slices, where the active scope cuts it over ``data`` (fsdp); else
    ``x`` itself."""
    scope = _SCOPE.get()
    dim = scope.fsdp.get(key) if scope is not None and scope.fsdp else None
    if dim is None:
        return x
    return _GatherData.apply(x, scope, dim)


def gather_params(p: Dict[str, torch.Tensor], stack: str) -> Dict[str, torch.Tensor]:
    """``gather_leaf`` of each leaf of one layer's dict ``p`` of the stack
    at key ``stack`` (``"['layers']"``)."""
    scope = _SCOPE.get()
    if scope is None or not scope.fsdp:
        return p
    return {k: gather_leaf(v, f"{stack}[{k!r}]") for k, v in p.items()}


class _SumForward(torch.autograd.Function):
    """The row-parallel output: the sum over the model group forward, the
    identity backward."""

    @staticmethod
    def forward(ctx, x, scope):
        out = x.clone(memory_format=torch.contiguous_format)
        return scope.group.all_reduce_(out, group=scope.model)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """A column-parallel input: the identity forward, the gradient summed
    over the model group backward (in f32, rounded once)."""

    @staticmethod
    def forward(ctx, x, scope):
        ctx.scope = scope
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.to(torch.float32, memory_format=torch.contiguous_format,
                   copy=True)
        ctx.scope.group.all_reduce_(g32, group=ctx.scope.model)
        return g32.to(g.dtype), None


class _SumBoth(torch.autograd.Function):
    """A sum over the model group of values every rank goes on to use
    whole (a row's sum of squares over split channels): the sum forward,
    and backward the sum of each rank's partial gradient of it."""

    @staticmethod
    def forward(ctx, x, scope):
        ctx.scope = scope
        out = x.clone(memory_format=torch.contiguous_format)
        return scope.group.all_reduce_(out, group=scope.model)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.scope.group.all_reduce_(g, group=ctx.scope.model), None


def split_sum(x: torch.Tensor, block: str) -> torch.Tensor:
    """``x`` (f32) summed over the model group forward and backward where
    the active plan splits ``block`` (:class:`_SumBoth`); else ``x``."""
    if not splits(block):
        return x
    return _SumBoth.apply(x, _SCOPE.get())


def split_ways(block: str) -> int:
    """The ranks ``block`` is split over (1 where it is whole)."""
    return _SCOPE.get().plan.mp if splits(block) else 1


def enter_split(x: torch.Tensor, block: str) -> torch.Tensor:
    """``x`` where it enters the split part of ``block`` (the input of the
    q/k/v projections, of the FFN's gate and up, of the MoE block, of
    RWKV6's time-mix and channel-mix key, of Mamba2): the
    identity, whose gradient is summed over the model group when the
    active plan splits ``block``."""
    if not splits(block):
        return x
    return _SumBackward.apply(x, _SCOPE.get())


def reduce_partial(x: torch.Tensor, block: str) -> torch.Tensor:
    """Complete a down-projection's partial sum over the model group (every
    rank of a serve engine) when the active plan splits ``block``
    (:class:`_SumForward`: the identity backward).  A partial in a
    narrower type is summed in f32 and cast back once.  Without a scope,
    or for a replicated block, ``x`` as it is."""
    if not splits(block):
        return x
    return _SumForward.apply(x.float(), _SCOPE.get()).to(x.dtype)


class _F32Product(torch.autograd.Function):
    """``torch.mm(h, w, out_dtype=torch.float32)`` with its gradients in
    the operands' type (the upstream gradient of an f32 partial that is
    rounded once after its sum holds values of that type exactly)."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return g @ w.T, h.T @ g


def f32_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` (``h`` (..., K), ``w`` (K, N)) accumulated and returned in
    f32, not rounded to the operands' narrower type: on a card the GEMM
    with an f32 output, on the CPU (which has none) the product of the
    upcast operands."""
    if h.dtype == torch.float32:
        return h @ w
    if h.is_cuda:
        out = _F32Product.apply(h.reshape(-1, h.shape[-1]), w)
        return out.reshape(*h.shape[:-1], w.shape[-1])
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
