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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core import VPE, block_until_ready
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


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    num_microbatches: int = 1,
    impl: Optional[Dict[str, str]] = None,
    compress_grads: bool = False,
) -> Callable:
    """Train step: (params, opt_state, batch, lr) -> (params, opt_state,
    metrics), with params and state updated in place.  With
    ``num_microbatches > 1`` the grads are accumulated in f32 and divided
    by the count; ``grad_norm`` is taken before the clip, and
    ``compress_grads`` applies error feedback before AdamW.  The two
    halves run under profiler ranges (``train_step.loss_and_grads``,
    ``train_step.optimizer``) that a trace reads; outside a profiler they
    cost a few microseconds."""
    cfg = dataclasses.replace(cfg, **(impl or {}))

    def loss_and_grads(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_() for p in leaves]
            loss = model_lib.loss_fn(cfg, pytree.tree_unflatten(leaves, spec), batch)
            # a leaf the loss never reads (a hybrid's empty tail stack) gets
            # a zero gradient, as jax.grad gives it
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), list(grads), spec

    def train_step(params, opt_state, batch, lr):
        with record_function("train_step.loss_and_grads"):
            loss, grads, spec = accumulate(params, batch)
        with record_function("train_step.optimizer"):
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
        gnorm = adamw.global_norm(grads)
        if compress_grads:
            grads, new_ef = compression.ErrorFeedback.apply(grads, opt_state["ef"])
        inner = {k: v for k, v in opt_state.items() if k != "ef"}
        params, inner = adamw.update(opt_cfg, grads, inner, params, lr=lr)
        new_opt = dict(inner)
        if compress_grads:
            new_opt["ef"] = new_ef
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": float(lr)}
        return params, new_opt, metrics

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
    that cannot run it fails here and no timed step pays for the build."""

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
    ) -> None:
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.data = data_stream
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        if params is None:
            params = model_lib.init_params(
                cfg, torch.Generator(self.device).manual_seed(seed))
        self.params = params
        self.opt_state = init_opt_state(self.opt_cfg, self.params,
                                        compress_grads=loop_cfg.compress_grads)
        self.vpe = vpe or VPE(controller_kwargs=dict(min_samples=3, trial_samples=3))
        axes = IMPL_AXES.get(cfg.family, {}) if loop_cfg.enable_vpe else {}
        self.tuner = ImplTuner(self.vpe, axes)
        self.watchdog = StepWatchdog() if loop_cfg.watchdog else None
        self.step = 0
        self.metrics_log: List[Dict[str, float]] = []
        self._bound_impl: Optional[Dict[str, str]] = None
        self._step_fn = None
        self.fault_hook: Optional[Callable[[int], None]] = None  # tests inject faults
        if self.device.type == "cuda" and not cfg.attention_free:
            kflash.prepare(getattr(torch, cfg.dtype), cfg.num_heads,
                           cfg.num_kv_heads, cfg.head_dim, self.device)

    # -- step (re)binding when the VPE selects another variant ---------------
    def _build(self, impl: Dict[str, str]) -> None:
        self._step_fn = make_train_step(
            self.cfg, self.opt_cfg,
            num_microbatches=self.loop_cfg.num_microbatches,
            impl=impl,
            compress_grads=self.loop_cfg.compress_grads,
        )
        self._bound_impl = impl

    def _lr(self) -> float:
        return schedule.warmup_cosine(
            self.step, peak_lr=self.loop_cfg.peak_lr,
            warmup_steps=self.loop_cfg.warmup_steps,
            total_steps=self.loop_cfg.total_steps)

    def run_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One fenced step on ``batch`` (arrays or tensors).  Raises
        :class:`StragglerTimeout` after a late step, which is kept."""
        batch = {k: (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.asarray(v))).to(self.device)
                 for k, v in batch.items()}
        impl = self.tuner.current()
        if self._step_fn is None or impl != self._bound_impl:
            self._build(impl)
        if self.fault_hook is not None:
            self.fault_hook(self.step)
        t0 = time.perf_counter()
        out = self._step_fn(self.params, self.opt_state, batch, self._lr())
        late = None
        try:
            if self.watchdog is not None:
                out = self.watchdog.guard(out)
            else:
                out = block_until_ready(out)
        except StragglerTimeout as e:
            late = e                # the fence drained: the step is done
        dt = time.perf_counter() - t0
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
        if not self.loop_cfg.checkpoint_dir:
            return None
        tree = {"params": self.params, "opt": self.opt_state}
        extra = {
            "vpe": self.vpe.state_dict(),
            "data": self.data.state_dict() if hasattr(self.data, "state_dict") else {},
            "step": self.step,
        }
        return ckpt.save(self.loop_cfg.checkpoint_dir, self.step, tree, extra=extra)

    def restore(self) -> bool:
        """Rewind to the latest checkpoint, written into the live params
        and optimizer state in place.  False when there is none."""
        d = self.loop_cfg.checkpoint_dir
        if not d or ckpt.latest_step(d) is None:
            return False
        _, extra, step = ckpt.restore(d, {"params": self.params, "opt": self.opt_state})
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
