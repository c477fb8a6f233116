"""Mixture-of-Experts layer: shared experts + routed top-k experts.

The counterpart of ``repro.models.moe``, with its semantics step for step:
scatter-based capacity routing (no (N, E, C) one-hot dispatch tensor).

  1. router logits in f32 -> softmax gates -> top-k experts and their
     gates, renormalised over the k when ``norm_topk_prob``;
  2. each assignment's position in its expert from a cumsum over the
     (G, n*k) token-major, k-minor assignment order;
  3. tokens scattered into an (E, C, d) buffer per group in ``x.dtype``;
     an assignment at or past capacity C is dropped (it adds zeros);
  4. per-expert SwiGLU as einsums over the stacked (E, d, f) weights;
  5. gathered back, weighted over k in f32, plus the shared SwiGLU
     branch, cast back to ``x.dtype``.

Every step keeps its shapes fixed and reads no value on the host (the
one-hot is a comparison against ``arange``, the positions a cumsum and a
gather, the scatter an ``index_add``), so a decode step through this
block can be captured in a CUDA graph.  The reference pins the buffer's
sharding for expert parallelism and GSPMD splits the products.  On a rank
of a head-sharded engine (:mod:`repro_torch.distributed.sharding`) the
router, top-k and capacity dispatch run over all experts on the same
rows, so every rank drops the same assignments; the rank's expert
products run over its slice of the experts (or of each expert's hidden
columns), the other experts contribute zero, and the combined partial sum
(routed and shared) is completed over the ranks before the cast.

This matches qwen2-moe (4 shared + 60 routed top-4, norm_topk_prob) and
moonlight (2 shared + 64 routed top-6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.group import (active_scope, enter_split,
                                           f32_product, reduce_partial, splits)

from .layers import Params, dense_init, init_swiglu, swiglu_param_shapes


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    num_experts: int
    top_k: int
    moe_d_ff: int            # per-expert hidden
    num_shared_experts: int  # folded into one shared SwiGLU of width n*moe_d_ff
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    # pad the expert dimension up to a multiple of this (the reference's
    # expert-parallel sharding); padded experts get weights, never tokens
    pad_to: int = 0

    @property
    def padded_experts(self) -> int:
        if self.pad_to <= 0:
            return self.num_experts
        return ((self.num_experts + self.pad_to - 1) // self.pad_to) * self.pad_to

    @property
    def shared_d_ff(self) -> int:
        return self.num_shared_experts * self.moe_d_ff


def moe_param_shapes(s: MoESpec) -> Dict[str, Tuple]:
    e = s.padded_experts
    shapes = {
        "router": (s.d_model, s.num_experts),
        "experts_gate": (e, s.d_model, s.moe_d_ff),
        "experts_up": (e, s.d_model, s.moe_d_ff),
        "experts_down": (e, s.moe_d_ff, s.d_model),
    }
    if s.num_shared_experts:
        shapes.update({f"shared_{k}": v for k, v in
                       swiglu_param_shapes(s.d_model, s.shared_d_ff).items()})
    return shapes


def init_moe(gen: torch.Generator, s: MoESpec, dtype: torch.dtype) -> Params:
    """The reference's distributions on ``gen``'s device: an f32 router,
    expert weights N(0, 1/d_model) (down: 1/moe_d_ff) in ``dtype``."""
    dev = gen.device
    e = s.padded_experts

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev).mul_(std).to(dtype)

    p: Params = {
        "router": dense_init(gen, s.d_model, s.num_experts, torch.float32),
        "experts_gate": normal((e, s.d_model, s.moe_d_ff), 1.0 / math.sqrt(s.d_model)),
        "experts_up": normal((e, s.d_model, s.moe_d_ff), 1.0 / math.sqrt(s.d_model)),
        "experts_down": normal((e, s.moe_d_ff, s.d_model), 1.0 / math.sqrt(s.moe_d_ff)),
    }
    if s.num_shared_experts:
        p.update({f"shared_{k}": v for k, v in
                  init_swiglu(gen, s.d_model, s.shared_d_ff, dtype).items()})
    return p


def capacity(s: MoESpec, n_tokens: int) -> int:
    c = int(math.ceil(s.capacity_factor * n_tokens * s.top_k / s.num_experts))
    return max(8, ((c + 7) // 8) * 8)  # pad to vector lanes


def route(s: MoESpec, router_w: torch.Tensor, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, d) -> (weights (N, k) f32, experts (N, k) int64)."""
    logits = x.float() @ router_w.float()
    gates = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(gates, s.top_k, dim=-1)
    if s.norm_topk_prob:
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return weights, experts


def dispatch(s: MoESpec, experts: torch.Tensor, C: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """experts: (G, n*k) in assignment order -> (keep (G, n*k) bool, slot
    (G, n*k) int64): each assignment's row ``expert * C + position`` in its
    group's (E*C) buffer (row ``expert * C`` for a dropped one)."""
    ids = torch.arange(s.num_experts, device=experts.device)
    onehot = (experts[..., None] == ids).to(torch.int32)        # (G, n*k, E)
    pos = torch.cumsum(onehot, dim=1) - 1                        # per-group positions
    pos = torch.gather(pos, 2, experts[..., None])[..., 0]
    keep = pos < C
    return keep, experts * C + torch.where(keep, pos, 0)


def _routed_experts(p: Params, s: MoESpec, xg: torch.Tensor,
                    expert0: int = 0, f32_down: bool = False) -> torch.Tensor:
    """Group-wise routed branch.  xg: (G, n, d) -> (G, n, d) in f32.

    Capacity is per (group, expert) and the scatter and gather stay inside
    the group; G = 1 is global routing.  When ``p`` holds a slice of the
    experts (fewer than ``s.padded_experts``, from expert ``expert0`` on),
    the assignments are dispatched over all experts as without the slice
    and only those to the slice are computed: the others add zero.  With
    ``f32_down`` (``p`` holds a slice of each expert's hidden columns) the
    down-projection's partial is computed in f32, to be summed over the
    ranks before any rounding."""
    G, n, d = xg.shape
    E, k = s.padded_experts, s.top_k
    C = capacity(s, n)
    dev = xg.device
    weights, experts = route(s, p["router"], xg.reshape(G * n, d))
    weights = weights.reshape(G, n * k)
    keep, slot = dispatch(s, experts.reshape(G, n * k), C)
    El = p["experts_gate"].shape[0]
    if El != E:
        mine = (slot >= expert0 * C) & (slot < (expert0 + El) * C)
        keep = keep & mine
        slot = torch.where(mine, slot - expert0 * C, 0)
        E = El
    # one buffer for all groups: group g's rows start at g * E * C
    rows = (slot + torch.arange(G, device=dev)[:, None] * (E * C)).reshape(-1)

    token_idx = torch.arange(n * k, device=dev) // k            # token-major, k-minor
    contrib = torch.where(keep[..., None], xg[:, token_idx, :], 0)
    buf = torch.zeros((G * E * C, d), dtype=xg.dtype, device=dev)
    buf = buf.index_add(0, rows, contrib.reshape(G * n * k, d)).reshape(G, E, C, d)

    g_ = torch.einsum("gecd,edf->gecf", buf, p["experts_gate"])
    u_ = torch.einsum("gecd,edf->gecf", buf, p["experts_up"])
    act, w_down = F.silu(g_) * u_, p["experts_down"]
    if f32_down:
        act, w_down = act.float(), w_down.float()
    eo = torch.einsum("gecf,efd->gecd", act, w_down)

    out_k = eo.reshape(G * E * C, d)[rows].reshape(G, n * k, d)
    out_k = out_k * torch.where(keep, weights, 0.0)[..., None]   # f32
    return torch.sum(out_k.reshape(G, n, k, d), dim=2)


def moe_block(p: Params, s: MoESpec, x: torch.Tensor, *, groups: int = 1
              ) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Routes the B*S rows together, in
    ``groups`` groups (one when B*S does not divide)."""
    B, S, d = x.shape
    N = B * S
    if N % max(groups, 1):
        groups = 1
    # on a rank whose plan splits the block: its slice of the experts or
    # of each expert's columns, and of the shared expert's columns, each
    # partial in f32 and all summed over the ranks at once; the router,
    # replicated, weighs only the rank's experts or columns, so the
    # input's gradient is summed over the ranks too
    xf = enter_split(x.reshape(N, d), "ffn")
    split = splits("ffn")
    mode = active_scope().plan.moe if split else None
    expert0 = (active_scope().index * p["experts_gate"].shape[0]
               if mode == "experts" else 0)
    out = _routed_experts(p, s, xf.reshape(max(groups, 1), -1, d), expert0,
                          f32_down=mode == "columns").reshape(N, d)
    if s.num_shared_experts:
        shared_p = {k[len("shared_"):]: v for k, v in p.items() if k.startswith("shared_")}
        hid = F.silu(xf @ shared_p["w_gate"]) * (xf @ shared_p["w_up"])
        out = out + (f32_product(hid, shared_p["w_down"]) if split
                     else hid @ shared_p["w_down"])
    return reduce_partial(out, "ffn").to(x.dtype).reshape(B, S, d)


def aux_load_balance_loss(s: MoESpec, router_w: torch.Tensor, x: torch.Tensor
                          ) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean over tokens)."""
    N = x.shape[0] * x.shape[1]
    xf = x.reshape(N, -1)
    logits = xf.float() @ router_w.float()
    gates = torch.softmax(logits, dim=-1)
    _, experts = torch.topk(gates, s.top_k, dim=-1)
    ids = torch.arange(s.num_experts, device=x.device)
    frac_tokens = torch.mean(
        (experts[..., None] == ids).float().sum(dim=1), dim=0
    ) / s.top_k  # normalized so the balanced value is 1.0 for any k
    frac_probs = torch.mean(gates, dim=0)
    return s.num_experts * torch.sum(frac_tokens * frac_probs)
