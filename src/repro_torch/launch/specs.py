"""A rank's step and its arguments, on ``device="meta"``, for every (arch x
shape) cell.

The counterpart of ``repro.launch.specs``.  The reference builds abstract
``ShapeDtypeStruct`` arguments with their shardings and lowers one SPMD
program for the whole mesh.  The port runs one process a rank, so a cell
here is one rank's view of it (rank 0, at ``(d, m) = (0, 0)``): its shard
of the parameters (the model split of :mod:`repro_torch.distributed.sharding`
and, under fsdp, its data slice), the AdamW state (and the error feedback
under ``compress_grads``), its rows of the batch (``rank_rows``), and for
prefill and decode the lockstep cache of its rows at its heads; every
tensor on the meta device, which allocates nothing, so a full-size config
costs no memory.  :class:`Built` holds them with the step to run on them,
under the rank's scope.  The step's collectives go to a
:class:`CountingGroup`, which records each one's result bytes by kind and
needs no process group.

The policies are the reference's: :func:`auto_tp` (no model axis below
1e9 parameters: the batch shards over both axes instead, as a
``(dp * mp, 1)`` mesh here), :func:`auto_fsdp` (shard over ``data`` when
the TP-sharded bf16 params and f32 master, m and v pass 12 GB a device)
and :func:`effective_microbatches`; they take the port's
:class:`~repro_torch.distributed.elastic.Mesh`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.elastic import Mesh
from repro_torch.distributed.group import MeshGroups
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import (MeshShard, init_opt_state, make_train_step,
                                            rank_rows)

META = torch.device("meta")
# an all-reduce by MAX (the error feedback's block scales) is its own kind
COLLECTIVES = ("all-reduce", "all-reduce-max", "all-gather", "reduce-scatter")


def dry_mesh(dp: int, mp: int) -> Mesh:
    """A ``(dp, mp)`` grid of placeholder devices (nothing is placed)."""
    return Mesh(("meta",) * (dp * mp), (dp, mp))


class CountingGroup:
    """A rank's :class:`~repro_torch.distributed.group.ShardGroup` that moves
    nothing: each collective records the bytes of its result on this rank
    (an all-gather's whole, a reduce-scatter's slice, an all-reduce's
    tensor), by kind, and returns its argument as it is."""

    backend = "counting"

    def __init__(self, rank: int, world: int) -> None:
        self.rank, self.world = rank, world
        self.bytes: Dict[str, int] = collections.Counter()
        self.counts: Dict[str, int] = collections.Counter()

    def _record(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] += nbytes
        self.counts[kind] += 1

    def all_reduce_(self, x: torch.Tensor, group: Any = None,
                    op: str = "sum") -> torch.Tensor:
        self._record("all-reduce" if op == "sum" else f"all-reduce-{op}", x.nbytes)
        return x

    def all_gather_(self, parts: List[torch.Tensor], x: torch.Tensor,
                    group: Any = None) -> List[torch.Tensor]:
        self._record("all-gather", x.nbytes * len(parts))
        return parts

    def reduce_scatter_(self, out: torch.Tensor, parts: List[torch.Tensor],
                        group: Any = None) -> torch.Tensor:
        self._record("reduce-scatter", out.nbytes)
        return out

    def summary(self) -> Dict[str, Any]:
        """Bytes by kind and their ``total`` (``repro.launch.hlo``'s keys),
        and the calls by kind."""
        out: Dict[str, Any] = {k: int(self.bytes[k]) for k in COLLECTIVES}
        out["total"] = sum(out[k] for k in COLLECTIVES)
        out["counts"] = {k: int(self.counts[k]) for k in COLLECTIVES}
        return out


def counting_groups(dp: int, mp: int, rank: int = 0) -> MeshGroups:
    """Rank ``rank``'s place on a ``(dp, mp)`` grid over a
    :class:`CountingGroup` (subgroups are their ranks' tuples)."""
    return MeshGroups(CountingGroup(rank, dp * mp), dp, mp, new_group=tuple)


# -- the reference's policies ---------------------------------------------------------

def auto_tp(cfg: ModelConfig, mesh: Mesh, *, min_params: float = 1e9) -> bool:
    """No tensor parallelism for tiny models: below ``min_params`` the
    model replicates over the model axis and the batch shards over both
    axes (pure data parallelism)."""
    return cfg.param_count() >= min_params


def auto_fsdp(cfg: ModelConfig, mesh: Mesh, *, hbm_budget_gb: float = 12.0) -> bool:
    """Shard weights and optimizer state over ``data`` only when the
    TP-sharded bf16 params and f32 m, v and master (14 bytes a parameter)
    pass ``hbm_budget_gb`` a device."""
    tp = mesh.shape[1]
    return cfg.param_count() * 14.0 / tp / 1e9 > hbm_budget_gb


def effective_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                           build_kwargs: Optional[Dict] = None) -> int:
    """The microbatch count :func:`build_train` uses."""
    bkw = build_kwargs or {}
    if bkw.get("num_microbatches"):
        return int(bkw["num_microbatches"])
    tp = bkw.get("tp", "auto")
    if tp == "auto":
        tp = auto_tp(cfg, mesh)
    return 1 if not tp else shape.num_microbatches


# -- meta arguments -------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                device: torch.device = META) -> Dict[str, torch.Tensor]:
    """The global batch: tokens and labels (B, S) int32, and for encdec the
    stub frames (B, source_len, d) bf16."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32, device=device),
             "labels": torch.empty((B, S), dtype=torch.int32, device=device)}
    if cfg.family == "encdec":
        specs["frames"] = torch.empty((B, cfg.source_len, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    return specs


def leaf_dtypes(cfg: ModelConfig) -> Dict[str, torch.dtype]:
    """Each parameter leaf's dtype by key string (an MoE router, a Mamba2
    ``A_log``, RWKV6's decay stay f32 in a bf16 model), read from the
    reduced config's parameters drawn on the CPU in ``cfg``'s dtype."""
    small = dataclasses.replace(cfg.reduced(), dtype=cfg.dtype)
    params = model_lib.init_params(small, torch.Generator().manual_seed(0))
    return {path: leaf.dtype for path, leaf in sharding._walk(params)}


def meta_params(cfg: ModelConfig, shard: Optional[MeshShard]) -> Any:
    """The rank's parameters as meta tensors: each leaf of
    ``param_shapes`` cut as the rank holds it."""
    dtypes = leaf_dtypes(cfg)

    def leaf(path, shape):
        if shard and shard.scope:
            shape = sharding.cut_shape(shape, shard.cuts(path, shape))
        return torch.empty(shape, dtype=dtypes[path], device=META)
    shapes = model_lib.param_shapes(cfg)
    return sharding._unflatten(shapes, {path: leaf(path, shape)
                                        for path, shape in sharding._walk(shapes)})


def _rows(batch: Dict[str, torch.Tensor], dp: int, d: int,
          num_microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """Data rank ``d``'s rows of the global batch (all of it where the
    parts are not whole rows, as ``fit_spec`` replicates it)."""
    B = batch["tokens"].shape[0]
    rows = rank_rows(B, dp, d, num_microbatches)
    if rows is None:
        return batch
    return {k: torch.empty((len(rows), *v.shape[1:]), dtype=v.dtype, device=v.device)
            for k, v in batch.items()}


def tree_bytes(tree: Any) -> int:
    return sum(t.nbytes for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Built:
    """A rank's step and its meta arguments: ``fn(*args)`` runs the step
    (under the rank's scope); ``state`` is the part of ``args`` that is the
    rank's held state (params and optimizer state, or params and cache);
    ``group`` the :class:`CountingGroup` its collectives reach."""

    kind: str
    fn: Callable
    args: Tuple
    state: Tuple
    group: CountingGroup
    mesh: Tuple[int, int]
    fsdp: bool
    tp: bool
    num_microbatches: int = 1
    local_cfg: Optional[ModelConfig] = None

    def run(self) -> Any:
        return self.fn(*self.args)


def _layout(cfg: ModelConfig, mesh: Mesh, tp: bool) -> Tuple[int, int]:
    dp, mp = mesh.shape
    return (dp, mp) if tp else (dp * mp, 1)


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                *, fsdp: Any = "auto", tp: Any = "auto",
                num_microbatches: Optional[int] = None,
                compress_grads: bool = False) -> Built:
    """One rank's train step on ``mesh``: ``fsdp`` and ``tp`` resolve as the
    reference's (``"auto"``); without TP the whole global batch is one
    microbatch and shards over both axes."""
    if tp == "auto":
        tp = auto_tp(cfg, mesh)
    if fsdp == "auto":
        fsdp = auto_fsdp(cfg, mesh)
    nmb = shape.num_microbatches if num_microbatches is None else num_microbatches
    if not tp and num_microbatches is None:
        nmb = 1
    dp, mp = _layout(cfg, mesh, tp)
    groups = counting_groups(dp, mp)
    shard = MeshShard(cfg, groups, fsdp=bool(fsdp))
    params = meta_params(cfg, shard)
    shard.bind(params)
    opt_cfg = adamw.AdamWConfig()
    opt = init_opt_state(opt_cfg, params, compress_grads=compress_grads)
    batch = _rows(batch_specs(cfg, shape), dp, groups.d, nmb)
    step = make_train_step(shard.local_cfg, opt_cfg, num_microbatches=nmb,
                           compress_grads=compress_grads, mesh=shard)
    return Built("train", step, (params, opt, batch, 3e-4), (params, opt),
                 groups.group, (dp, mp), shard.fsdp, bool(tp), nmb, shard.local_cfg)


def _serving(kind: str, cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
             fsdp: bool) -> Built:
    dp, mp = mesh.shape
    groups = counting_groups(dp, mp)
    shard = MeshShard(cfg, groups, fsdp=fsdp)
    params = meta_params(cfg, shard)
    batch = _rows(batch_specs(cfg, shape), dp, groups.d)
    local = shard.local_cfg
    cache = model_lib.init_cache(local, batch["tokens"].shape[0], shape.seq_len, META)
    context = shard.context

    if kind == "prefill":
        def fn(params, batch, cache):
            with torch.no_grad(), context():
                return model_lib.prefill(local, params, batch, cache)
        args = (params, batch, cache)
    else:
        tokens = batch["tokens"][:, :1]

        def fn(params, cache, tokens):
            with torch.no_grad(), context():
                return model_lib.decode_step(local, params, cache, tokens)
        args = (params, cache, tokens)
    return Built(kind, fn, args, (params, cache), groups.group, (dp, mp),
                 shard.fsdp, True, 1, local)


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                  *, fsdp: bool = True) -> Built:
    """One rank's lockstep prefill of its rows into its cache."""
    return _serving("prefill", cfg, shape, mesh, fsdp)


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                 *, fsdp: bool = True) -> Built:
    """One rank's lockstep decode step over its rows' full cache."""
    return _serving("decode", cfg, shape, mesh, fsdp)


BUILDERS: Dict[str, Callable] = {
    "train": build_train,
    "prefill": build_prefill,
    "decode": build_decode,
}


def build(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, **kw) -> Built:
    return BUILDERS[shape.kind](cfg, shape, mesh, **kw)
