"""Training runtime: the train step, VPE static dispatch, fault tolerance.

The counterpart of ``repro.runtime.train_loop``.  The VPE integration is
the *static* form of the paper's function-pointer swap: the attention
implementation is a VPE op whose "execution" is the whole train step.
The tuner feeds measured step seconds to the profiler; when the controller
switches a variant or starts a trial, the loop rebinds the step to the
implementation it now selects.  PyTorch runs eagerly, so the swap is a
rebind, not a compile, and the trial protocol (``min_samples=3``,
``trial_samples=3``) runs as in the reference — with one repair: the
reference rebuilds only when ``controller.version`` moves, which a trial's
start does not do, so its trial steps run the incumbent while their
seconds are booked to the candidate.  Here the step is rebound whenever
the selected variant changes, so a trial step runs the candidate.

The step updates params and optimizer state in place (``optim.adamw``),
so at full width the training state is held once.  One consequence for
the straggler ladder: a step that trips the watchdog has already
completed in place, so the loop keeps it rather than running it again,
and a second late step in a row escalates to restore-from-checkpoint.

**On a (data, model) mesh** (``mesh``: the rank's
:class:`~repro_torch.distributed.group.MeshGroups`, one process a rank):

* the rank holds its shard of the params and of the optimizer state
  (the model split of :mod:`~repro_torch.distributed.sharding`) and runs
  the loss and its backward at the shard's config under its
  :class:`~repro_torch.distributed.group.ShardScope`.  Over the data axis
  the state is replicated, or, with ``fsdp``, cut as the reference's rule
  table cuts it (``sharding.fsdp_slice``; the layout the reference's
  launcher always trains with): each leaf's slice is gathered where the
  model reads it, one layer at a time, and its gradient comes back
  reduce-scattered, already the data group's mean; AdamW updates the
  slice;
* it takes its rows of each global batch (:func:`rank_rows`);
* :class:`MeshShard` completes each leaf's gradient (the model group's
  partial sums of :func:`~repro_torch.distributed.sharding.grad_layout`,
  then the data group's mean, in f32, rounded once), takes the whole
  model's global norm (the squares of data slices summed over the data
  group) and quantizes the error feedback in the whole leaves' blocks;
  the loss is the data group's mean;
* rank 0 decides everything that reads a clock: the VPE's variant each
  step (fed the slowest rank's step seconds) and the watchdog's verdict,
  which every rank follows (``ShardGroup.agree``), so the ranks step,
  switch and restore together;
* a checkpoint is the whole tree, independent of the mesh: each data
  group gathers its slices (fsdp), the model group of data rank 0 its
  shards, and world rank 0 writes them;
  every rank restores its shard of the whole tree, so a checkpoint of
  any mesh (or of one device) restores at any other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core import VPE, block_until_ready
from repro_torch.core.spans import span
from repro_torch.data.pipeline import device_put_batch
from repro_torch.distributed import sharding
from repro_torch.distributed.group import MeshGroups, ShardScope, shard_scope
from repro_torch.distributed.straggler import StepWatchdog, StragglerTimeout
from repro_torch.kernels import flash_attention as kflash
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw, compression, schedule

STATIC_BUCKET = ("static",)

# implementation axes applicable per family (first variant = default)
IMPL_AXES: Dict[str, Dict[str, List[str]]] = {
    "dense": {"attn_impl": ["reference", "flash_cuda"]},
    "vlm": {"attn_impl": ["reference", "flash_cuda"]},
    "moe": {"attn_impl": ["reference", "flash_cuda"]},
    "encdec": {"attn_impl": ["reference", "flash_cuda"]},
    "hybrid": {"ssd_impl": ["chunked", "sequential"],
               "attn_impl": ["reference", "flash_cuda"]},
    "ssm": {"wkv_impl": ["chunked", "sequential"]},
}


class ImplTuner:
    """Static VPE dispatch over train-step implementation axes."""

    def __init__(self, vpe: VPE, axes: Dict[str, List[str]]) -> None:
        self.vpe = vpe
        self.axes = axes
        for axis, variants in axes.items():
            if not vpe.registry.has_op(axis):
                vpe.registry.register_op(axis)
                for i, v in enumerate(variants):
                    vpe.registry.register_variant(axis, v, fn=(lambda v=v: v),
                                                  default=(i == 0))

    def current(self) -> Dict[str, str]:
        return {axis: self.vpe.controller.select(axis, STATIC_BUCKET)
                for axis in self.axes}

    def record(self, seconds: float) -> None:
        for axis in self.axes:
            vname = self.vpe.controller.select(axis, STATIC_BUCKET)
            self.vpe.profiler.record(axis, vname, STATIC_BUCKET, seconds)
            self.vpe.controller.on_sample(axis, STATIC_BUCKET, vname)


def rank_rows(batch: int, dp: int, d: int, num_microbatches: int = 1
              ) -> Optional[np.ndarray]:
    """The rows of a global batch of ``batch`` rows that data rank ``d`` of
    ``dp`` trains on: its ``d``-th part of each microbatch, so that each
    microbatch is the reference's (GSPMD splits every microbatch over
    ``data``).  None, the whole batch on every data rank (as ``fit_spec``
    replicates it), when the parts are not whole rows."""
    mb = batch // num_microbatches
    if dp == 1 or batch % num_microbatches or mb % dp:
        return None
    per = mb // dp
    return np.concatenate([np.arange(i * mb + d * per, i * mb + (d + 1) * per)
                           for i in range(num_microbatches)])


class MeshShard:
    """A rank's part of training on a ``(dp, mp)`` mesh (module docstring):
    its shard of any params-shaped tree, its scope, and the completion of
    its gradients.  ``cfg`` is the whole model's; ``fsdp`` cuts the state
    over the data axis too (no effect at ``dp = 1``); :meth:`bind` orders
    the gradients' layout as the rank's params are flattened."""

    def __init__(self, cfg: ModelConfig, groups: MeshGroups, *,
                 fsdp: bool = False) -> None:
        self.cfg, self.groups = cfg, groups
        mp = groups.mp
        self.fsdp = fsdp and groups.dp > 1
        self.local_cfg = cfg
        self.scope: Optional[ShardScope] = None
        self.layout: Optional[List[sharding.GradLeaf]] = None
        self._by_path: Dict[str, sharding.GradLeaf] = {}
        if mp > 1 or self.fsdp:
            self.plan = sharding.shard_plan(cfg, mp)
            self.local_cfg = sharding.shard_config(cfg, mp)
            dp, d = (groups.dp, groups.d) if self.fsdp else (1, 0)
            self._by_path = dict(sharding._walk(sharding.grad_layout(
                cfg, mp, groups.m, model_lib.param_shapes(cfg), dp=dp, d=d)))
            dims = {path: leaf.data[0] - len(leaf.whole)
                    for path, leaf in self._by_path.items() if leaf.data is not None}
            self.scope = ShardScope(groups.group, self.plan, groups.model, groups.m,
                                    data=groups.data if self.fsdp else None, dp=dp,
                                    fsdp=dims or None)

    def bind(self, params: Any) -> None:
        """Order the gradients' layout as ``params`` (the rank's shard)
        flatten."""
        if self._by_path:
            self.layout = [self._by_path[path] for path, _ in sharding._walk(params)]

    def shard(self, tree: Any) -> Any:
        """The rank's part of a whole params-shaped tree."""
        if self.scope is None:
            return tree
        return sharding.map_leaves(tree, self.keep)

    def cuts(self, path: str, shape) -> List[Any]:
        """The cuts of the rank's slice of the whole leaf of ``shape`` at
        ``path`` (``sharding.rank_cuts``)."""
        g = self.groups
        dp = g.dp if self.fsdp else 1
        return sharding.rank_cuts(self.cfg, self.plan, g.m, g.d if self.fsdp else 0, dp,
                                  path, tuple(shape))

    def keep(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        """The rank's slice of one whole leaf at ``path`` (a copy where it
        is cut, so the whole leaf can be dropped); with a scope only."""
        return sharding.cut_leaf(leaf, self.cuts(path, leaf.shape))

    def data_cut(self, path: str) -> Optional[Any]:
        """The data cut (fsdp) of the leaf at ``path`` in any params-shaped
        tree (``['opt']['m']['layers']['attn_wq']``), or None."""
        while path:
            leaf = self._by_path.get(path)
            if leaf is not None:
                return leaf.data
            path = path[path.index("]") + 1:]
        return None

    def context(self):
        return shard_scope(self.scope) if self.scope else contextlib.nullcontext()

    def moe_groups(self, batch: int, seq: int, num_microbatches: int,
                   rows: Optional[np.ndarray]) -> int:
        """The routing groups of the rank's rows: the reference's
        ``moe_groups`` over its rows of each microbatch, which equals the
        reference's routing only when the groups split evenly over the
        data ranks.  Raises ``ValueError`` where they do not."""
        g, dp = self.cfg.moe_groups, self.groups.dp
        if self.cfg.family != "moe" or rows is None:
            return g
        n = batch // num_microbatches * seq
        if g % dp or n % g:
            raise ValueError(
                f"MoE routing on a data axis of {dp}: each data rank routes "
                f"its rows in moe_groups/dp groups, which is the reference's "
                f"routing only when moe_groups % dp == 0 and the rows of a "
                f"microbatch divide into the groups (B/num_microbatches * S "
                f"% moe_groups == 0); moe_groups={g}, B*S/num_microbatches={n}")
        return g // dp

    def sync(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each leaf's whole gradient for the rank's slice: the model
        group's partial sums, then the data group's mean, in f32 and
        rounded once to the gradient's type."""
        g_ = self.groups
        out = []
        for i, g in enumerate(grads):
            leaf = self.layout[i] if self.layout else None
            partial = leaf.partial if leaf else None
            # a slice cut over the data axis arrived as the data group's mean
            averaged = leaf is not None and leaf.data is not None
            shared = leaf is not None and leaf.shared is not None
            if partial is None and not shared and (g_.dp == 1 or averaged):
                out.append(g)
                continue
            g32 = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
            if leaf is not None and leaf.shared is not None:
                # the ranges every model rank holds (Mamba2's B/C): partials
                dim, runs = leaf.shared
                for s, n in runs:
                    part = g32.narrow(dim, s, n)
                    part.copy_(g_.model_sum_(part.contiguous()))
            if partial == "model":
                g_.model_sum_(g32)
            elif partial == "holders":
                buf = torch.zeros(leaf.whole, dtype=torch.float32, device=g.device)
                mine = buf.narrow(*leaf.cut)
                if averaged:
                    mine = mine.narrow(*leaf.data)
                mine.copy_(g32)
                g_.model_sum_(buf)
                g32 = mine.contiguous()
            out.append((g32 if averaged else g_.data_mean_(g32)).to(g.dtype))
        return out

    def norm(self, grads: Any) -> torch.Tensor:
        """The whole model's global norm of the rank's gradients (the ranges
        of a split leaf that every model rank holds counted once, as a
        replicated leaf is)."""
        if not self.layout:
            return adamw.global_norm(grads)
        parts, counted, data = [], [], []
        for g, leaf in zip(pytree.tree_leaves(grads), self.layout):
            own, shared = leaf.own_and_shared(g)
            for group, c in ((own, None if leaf.cut is None else leaf.counted),
                             (shared, None)):
                parts += group
                counted += [c] * len(group)
                data += [leaf.data is not None] * len(group)
        return adamw.global_norm(parts, counted=counted,
                                 model_sum=self.groups.model_sum_, data=data,
                                 data_sum=self.groups.data_sum_)

    def ef_splits(self) -> Optional[List[Any]]:
        if not self.layout:
            return None
        return [None if leaf.cut is None and leaf.data is None
                else (leaf.whole, leaf.cut, leaf.data) for leaf in self.layout]


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    num_microbatches: int = 1,
    impl: Optional[Dict[str, Any]] = None,
    compress_grads: bool = False,
    mesh: Optional[MeshShard] = None,
) -> Callable:
    """Train step: (params, opt_state, batch, lr) -> (params, opt_state,
    metrics), with params and state updated in place.  With
    ``num_microbatches > 1`` the grads are accumulated in f32 and divided
    by the count; ``grad_norm`` is taken before the clip, and
    ``compress_grads`` applies error feedback before AdamW.  The two
    halves run under profiler ranges (``train_step.loss_and_grads``,
    ``train_step.optimizer``) that a trace reads; outside a profiler they
    cost a few microseconds.

    With ``mesh`` (a rank of a training mesh) ``cfg`` is the shard's
    config, ``params`` and ``opt_state`` the rank's shard and ``batch``
    its rows; the gradients are completed by ``mesh.sync`` and the loss
    averaged over the data group before the optimizer half.  The step's
    ``grads(params, batch)`` gives (loss, the completed gradients) without
    the update."""
    cfg = dataclasses.replace(cfg, **(impl or {}))
    scope = mesh.context if mesh is not None else contextlib.nullcontext

    def loss_and_grads(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad(), scope():
            leaves = [p.detach().requires_grad_() for p in leaves]
            loss = model_lib.loss_fn(cfg, pytree.tree_unflatten(leaves, spec), batch)
            # a leaf the loss never reads (a hybrid's empty tail stack) gets
            # a zero gradient, as jax.grad gives it
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), list(grads), spec

    def grads_of(params, batch):
        loss, grads, spec = accumulate(params, batch)
        if mesh is not None:
            grads = mesh.sync(grads)
            loss = mesh.groups.data_mean_(loss.float())
        return loss, grads, spec

    def train_step(params, opt_state, batch, lr):
        with span("train_step.loss_and_grads"):
            loss, grads, spec = grads_of(params, batch)
        with span("train_step.optimizer"):
            return optimize(params, opt_state, loss, grads, spec, lr)

    def accumulate(params, batch):
        if num_microbatches == 1:
            loss, grads, spec = loss_and_grads(params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % num_microbatches:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"num_microbatches={num_microbatches}")
            mb = B // num_microbatches
            grads, losses = None, []
            for i in range(num_microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g, spec = loss_and_grads(params, part)
                if grads is None:
                    grads = [x.float() for x in g]
                else:
                    for a, x in zip(grads, g):
                        a.add_(x)
                losses.append(l)
            for a in grads:
                a.div_(num_microbatches)
            loss = torch.stack(losses).mean()
        return loss, grads, spec

    def optimize(params, opt_state, loss, grads, spec, lr):
        grads = pytree.tree_unflatten(grads, spec)
        norm = mesh.norm if mesh is not None else adamw.global_norm
        gnorm = norm(grads)
        clip_norm = gnorm
        if compress_grads:
            ef_kw = ({} if mesh is None else
                     dict(splits=mesh.ef_splits(), group=mesh.groups.model,
                          data_group=mesh.groups.data, comm=mesh.groups.group))
            grads, new_ef = compression.ErrorFeedback.apply(grads, opt_state["ef"],
                                                            **ef_kw)
            # the reference clips by the compressed gradients' norm
            clip_norm = norm(grads)
        inner = {k: v for k, v in opt_state.items() if k != "ef"}
        params, inner = adamw.update(opt_cfg, grads, inner, params, lr=lr,
                                     gnorm=clip_norm)
        new_opt = dict(inner)
        if compress_grads:
            new_opt["ef"] = new_ef
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": float(lr)}
        return params, new_opt, metrics

    def grads(params, batch):
        loss, g, spec = grads_of(params, batch)
        return loss, pytree.tree_unflatten(g, spec)

    train_step.grads = grads
    return train_step


def init_opt_state(opt_cfg: adamw.AdamWConfig, params, *,
                   compress_grads: bool = False):
    state = adamw.init(opt_cfg, params)
    if compress_grads:
        state["ef"] = compression.ErrorFeedback.init(params)
    return state


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    checkpoint_every: int = 0            # 0 = off
    checkpoint_dir: str = ""
    log_every: int = 10
    num_microbatches: int = 1
    compress_grads: bool = False
    enable_vpe: bool = True
    watchdog: bool = True


class TrainLoop:
    """Host-side driver: data, VPE tuner, checkpoints, fault handling.

    Parameters are drawn from ``seed`` on ``device`` unless given.  On a
    CUDA device the constructor builds the flash kernel and launches it
    once at the model's head shape (a family with attention), so a card
    that cannot run it fails here and no timed step pays for the build.

    With ``mesh`` (this rank's :class:`MeshGroups`; every rank of the grid
    builds its loop with the same arguments) ``params`` are the WHOLE
    parameters, of which the loop keeps the rank's shard, or none: each
    layer leaf is drawn from ``seed`` and cut to the rank's slice at once,
    the same numbers (module docstring); ``data_stream`` yields the global
    batch; ``fsdp`` cuts the params and optimizer state over the data axis
    as well (:class:`MeshShard`).  The loop reads its clock through
    ``clock`` (tests skew it)."""

    def __init__(
        self,
        cfg: ModelConfig,
        loop_cfg: TrainLoopConfig,
        data_stream,
        *,
        opt_cfg: Optional[adamw.AdamWConfig] = None,
        params: Any = None,
        seed: int = 0,
        vpe: Optional[VPE] = None,
        device: DeviceLike = "cuda",
        mesh: Optional[MeshGroups] = None,
        fsdp: bool = False,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.data = data_stream
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.clock = clock
        self.mesh = MeshShard(cfg, mesh, fsdp=fsdp) if mesh is not None else None
        if params is None:
            # on a mesh each layer leaf is cut to the rank's slice as it is
            # drawn: the card never holds the whole parameters
            params = model_lib.init_params(
                cfg, torch.Generator(self.device).manual_seed(seed),
                keep=self.mesh.keep if self.mesh and self.mesh.scope else None)
        elif self.mesh:
            params = self.mesh.shard(params)
        self.params = params
        del params
        if self.mesh:
            self.mesh.bind(self.params)
        self.opt_state = init_opt_state(self.opt_cfg, self.params,
                                        compress_grads=loop_cfg.compress_grads)
        self.vpe = vpe or VPE(controller_kwargs=dict(min_samples=3, trial_samples=3))
        axes = IMPL_AXES.get(cfg.family, {}) if loop_cfg.enable_vpe else {}
        self.tuner = ImplTuner(self.vpe, axes)
        self.watchdog = StepWatchdog(clock=clock) if loop_cfg.watchdog else None
        self.step = 0
        self.metrics_log: List[Dict[str, float]] = []
        self._bound_impl: Optional[Dict[str, str]] = None
        self._step_fn = None
        self.fault_hook: Optional[Callable[[int], None]] = None  # tests inject faults
        # the shard's config: its heads, hidden width and experts
        self.local_cfg = self.mesh.local_cfg if self.mesh else cfg
        if self.device.type == "cuda" and not cfg.attention_free:
            kflash.prepare(getattr(torch, cfg.dtype), self.local_cfg.num_heads,
                           self.local_cfg.num_kv_heads, cfg.head_dim, self.device)

    # -- step (re)binding when the VPE selects another variant ---------------
    def _build(self, impl: Dict[str, Any]) -> None:
        self._step_fn = make_train_step(
            self.local_cfg, self.opt_cfg,
            num_microbatches=self.loop_cfg.num_microbatches,
            impl=impl,
            compress_grads=self.loop_cfg.compress_grads,
            mesh=self.mesh,
        )
        self._bound_impl = impl

    def _agree(self, value: Any) -> Any:
        """Rank 0's ``value`` on a mesh (``value`` itself on one device)."""
        return self.mesh.groups.group.agree(value) if self.mesh else value

    def prepare(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Bind the step to the variants rank 0 selects (and, on a mesh,
        to the rank's routing groups) and return the rank's rows of the
        global ``batch`` on its device."""
        impl = dict(self._agree(self.tuner.current()))
        rows = None
        if self.mesh:
            g, n = self.mesh.groups, self.loop_cfg.num_microbatches
            B, S = (int(x) for x in np.shape(batch["tokens"]))
            rows = rank_rows(B, g.dp, g.d, n)
            impl["moe_groups"] = self.mesh.moe_groups(B, S, n, rows)
        if self._step_fn is None or impl != self._bound_impl:
            self._build(impl)
        return device_put_batch(batch, self.device, rows)

    def _lr(self) -> float:
        return schedule.warmup_cosine(
            self.step, peak_lr=self.loop_cfg.peak_lr,
            warmup_steps=self.loop_cfg.warmup_steps,
            total_steps=self.loop_cfg.total_steps)

    def run_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One fenced step on ``batch`` (arrays or tensors; on a mesh the
        global batch, of which the rank takes its rows).  Raises
        :class:`StragglerTimeout` after a late step, which is kept."""
        placed = self.prepare(batch)
        if self.fault_hook is not None:
            self.fault_hook(self.step)
        t0 = self.clock()
        out = self._step_fn(self.params, self.opt_state, placed, self._lr())
        late = None
        try:
            if self.watchdog is not None:
                out = self.watchdog.guard(out)
            else:
                out = block_until_ready(out)
        except StragglerTimeout as e:
            late = e                # the fence drained: the step is done
        dt = self.clock() - t0
        if self.mesh:
            # rank 0's verdict, and the slowest rank's seconds, on every rank
            verdict = self._agree(None if late is None else (late.elapsed, late.budget))
            late = None if verdict is None else StragglerTimeout(*verdict)
            dt = max(self.mesh.groups.group.gather(dt))
        self.params, self.opt_state, metrics = out
        if late is None:
            self.tuner.record(dt)
        m = {k: float(v) for k, v in metrics.items()}
        m["step_time_s"] = dt
        self.metrics_log.append(m)
        self.step += 1
        if late is not None:
            raise late
        return m

    # -- checkpointing -------------------------------------------------------
    def save(self) -> Optional[str]:
        """Write the whole training state (on a mesh: every rank calls it;
        each data group gathers its slices under fsdp, the model group of
        data rank 0 its shards, and world rank 0 writes them; the others
        return None once it is written)."""
        if not self.loop_cfg.checkpoint_dir:
            return None
        tree = {"params": self.params, "opt": self.opt_state}
        extra = {
            "vpe": self.vpe.state_dict(),
            "data": self.data.state_dict() if hasattr(self.data, "state_dict") else {},
            "step": self.step,
        }
        if not self.mesh:
            return ckpt.save(self.loop_cfg.checkpoint_dir, self.step, tree, extra=extra)
        g = self.mesh.groups
        path = None
        if g.d == 0 or self.mesh.fsdp:
            tree = sharding.map_leaves(tree, self._gathered)
            if g.group.rank == 0:
                path = ckpt.save(self.loop_cfg.checkpoint_dir, self.step, tree,
                                 extra=extra)
        torch.distributed.barrier()
        return path

    def _gathered(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        """The whole leaf on the host, from the data group's slices (fsdp)
        and then the model group's parts: they are gathered on the rank's
        device (NCCL takes no host tensors) and the whole leaf is copied to
        the host before the next is gathered.  None on a data rank other
        than 0, once its slice is sent."""
        g = self.mesh.groups
        part = leaf.detach()
        data = self.mesh.data_cut(path)
        if data is not None:
            part = part.contiguous()
            parts = [torch.empty_like(part) for _ in range(g.dp)]
            part = torch.cat(g.group.all_gather_(parts, part, group=g.data), data[0])
        if g.d != 0:
            return None
        if g.mp > 1 and sharding.splits_leaf(self.cfg, g.mp, path):
            part = part.contiguous()
            parts = [torch.empty_like(part) for _ in range(g.mp)]
            g.group.all_gather_(parts, part, group=g.model)
            part = sharding.unshard_leaf(self.cfg, g.mp, path, parts)
        return part.cpu()

    def restore(self) -> bool:
        """Rewind to the latest checkpoint, written into the live params
        and optimizer state in place (on a mesh, the rank's shard of the
        whole tree, whatever mesh wrote it).  False when there is none."""
        d = self.loop_cfg.checkpoint_dir
        if not d or ckpt.latest_step(d) is None:
            return False
        cut = self.mesh.cuts if self.mesh and self.mesh.scope else None
        _, extra, step = ckpt.restore(d, {"params": self.params, "opt": self.opt_state},
                                      cut=cut)
        if extra.get("vpe"):
            self.vpe.load_state_dict(extra["vpe"])
        if extra.get("data") and hasattr(self.data, "load_state_dict"):
            self.data.load_state_dict(extra["data"])
        self.step = int(extra.get("step", step))
        return True

    # -- full loop with fault handling ----------------------------------------
    def run(self, num_steps: Optional[int] = None) -> List[Dict[str, float]]:
        total = num_steps if num_steps is not None else self.loop_cfg.total_steps
        late_in_a_row = 0
        while self.step < total:
            batch = (self.data.batch_at(self.step) if hasattr(self.data, "batch_at")
                     else next(self.data))
            try:
                m = self.run_step(batch)
                late_in_a_row = 0
            except StragglerTimeout:
                # straggler mitigation: keep the late step (it completed in
                # place); a second late step in a row escalates to
                # restore-from-checkpoint
                late_in_a_row += 1
                if late_in_a_row >= 2:
                    late_in_a_row = 0
                    if not self.restore():
                        raise
                    continue
                m = self.metrics_log[-1]
            if self.loop_cfg.log_every and self.step % self.loop_cfg.log_every == 0:
                print(f"step {self.step}: loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.2f} {m['step_time_s']*1e3:.0f}ms")
            if (self.loop_cfg.checkpoint_every
                    and self.step % self.loop_cfg.checkpoint_every == 0):
                self.save()
        return self.metrics_log
