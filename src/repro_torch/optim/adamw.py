"""AdamW with optional bf16-param / f32-master mixed precision.

The counterpart of ``repro.optim.adamw``, on dicts of tensors: the same
math in f32.  Where JAX builds new trees, :func:`update` writes ``m``,
``v``, the master copy and the params in place, one tensor at a time and
each in slices of at most ``PIECE`` elements along its leading axis, and
applies the clip factor slice by slice.  So a step holds no second copy
of the grads or of the state: the training state of bf16 params stays at
16 bytes per parameter (bf16 param and grad, f32 ``m``, ``v`` and master).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import torch
from torch.utils import _pytree as pytree

# elements per slice of the in-place update: bounds its f32 temporaries
PIECE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # keep an f32 master copy when params are low precision
    master_copy: bool = True


def needs_master(params: Any) -> bool:
    return any(leaf.dtype != torch.float32 for leaf in pytree.tree_leaves(params))


def init(cfg: AdamWConfig, params: Any) -> Dict[str, Any]:
    """``step`` (a 0-d int32 tensor on the CPU: the host reads it every
    update), f32 ``m`` and ``v``, and an f32 ``master`` copy when a param
    is low precision — each on its param's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    state = {
        "step": torch.zeros((), dtype=torch.int32),
        "m": pytree.tree_map(zeros, params),
        "v": pytree.tree_map(zeros, params),
    }
    if cfg.master_copy and needs_master(params):
        state["master"] = pytree.tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree: Any, *, counted: Optional[Sequence[Optional[bool]]] = None,
                model_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                data: Optional[Sequence[bool]] = None,
                data_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor on
    the leaves' device).

    On a rank of a model-parallel mesh the tree is the rank's shard and
    the norm is still the whole model's: ``counted`` gives, leaf by leaf,
    True for a split leaf whose squares this rank adds to the model
    group's sum (``model_sum``, in place), False for a copy of a slice
    another rank counts, None for a leaf whole on every rank (counted
    here, once).  ``data``, leaf by leaf: True for a leaf cut over the data
    axis (fsdp), whose squares are summed over the data group
    (``data_sum``, in place) as well.  Every rank of the mesh then gets the
    same norm, so the clip factor is the same on all of them."""
    leaves = pytree.tree_leaves(tree)
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32) for x in leaves]
    if counted is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    data = data or [False] * len(norms)
    zero = torch.zeros((), dtype=torch.float32, device=norms[0].device)

    def squares(model_cut, data_cut):
        return sum((n * n for n, c, d in zip(norms, counted, data)
                    if (c if model_cut else c is None) and d == data_cut), zero.clone())
    whole, split = squares(False, False), squares(True, False)
    if any(data):
        # one sum over the data group: the slices of replicated leaves, and
        # of split leaves (then summed over the model group with the rest)
        cut = data_sum(torch.stack([squares(False, True), squares(True, True)]))
        whole, split = whole + cut[0], split + cut[1]
    return torch.sqrt(whole + model_sum(split))


def clip_by_global_norm(grads: Any, max_norm: float,
                        gnorm: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(factor, global norm): the clipped grads are ``g * factor`` in f32.
    The reference returns the scaled f32 tree; the port returns the factor
    and :func:`update` applies it slice by slice, so no f32 copy of the
    grads is made.  ``gnorm``: the norm to clip by where the caller has it
    (a mesh rank's :func:`global_norm`)."""
    gn = global_norm(grads) if gnorm is None else gnorm
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0), gn


def _pieces(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching views of ``ts`` (one shape) in slices of about ``PIECE``
    elements along the leading axis (whole rows; a row larger than
    ``PIECE`` is one slice)."""
    t0 = ts[0]
    if t0.ndim == 0 or t0.numel() <= PIECE:
        yield ts
        return
    rows = max(1, PIECE // (t0.numel() // t0.shape[0]))
    for i in range(0, t0.shape[0], rows):
        yield tuple(t[i:i + rows] for t in ts)


def update(
    cfg: AdamWConfig,
    grads: Any,
    state: Dict[str, Any],
    params: Any,
    lr: Optional[Union[float, torch.Tensor]] = None,
    gnorm: Optional[torch.Tensor] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Returns (params, state), both updated in place.  grads in any
    dtype; math in f32.  ``gnorm``: the global norm the clip uses, where
    the caller has it (a mesh rank's is the whole model's, not its
    shard's); by default that of ``grads``."""
    step = int(state["step"]) + 1
    lr = cfg.lr if lr is None else lr
    scale = (clip_by_global_norm(grads, cfg.grad_clip, gnorm)[0]
             if cfg.grad_clip else None)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    has_master = "master" in state
    masters = state["master"] if has_master else params
    for leaves in zip(*(pytree.tree_leaves(t) for t in
                        (grads, state["m"], state["v"], masters, params))):
        for g, m, v, p32, p in _pieces(*leaves):
            g32 = g.float() if scale is None else g.float() * scale
            m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
            upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
            p32.sub_(upd.add_(p32, alpha=cfg.weight_decay).mul_(lr))
            if has_master:
                p.copy_(p32)
    state["step"].fill_(step)
    return params, state
