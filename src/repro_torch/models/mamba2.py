"""Mamba2 (SSD) block — zamba2's backbone.

The counterpart of ``repro.models.mamba2``, step for step.  The reference
computes the scan outside any Pallas kernel, so it is plain PyTorch here
too.  Two variants of the ``ssm_scan`` op (``SSD_VARIANTS``):

  * ``chunked`` — per chunk of ``c`` steps, dense (c x c) products plus a
    carry of the state from chunk to chunk (the default);
  * ``sequential`` — one step at a time (the oracle, and what a one-token
    decode call takes whatever ``ssd_impl`` says).

Recurrence (per head, state N, head dim P):
    a_t = exp(A * dt_t)            A < 0 scalar per head
    h_t = a_t * h_{t-1} + dt_t * (x_t outer B_t)        h: (P, N)
    y_t = h_t @ C_t + D * x_t

``A_log``, ``D`` and ``dt_bias`` are f32 leaves in a bf16 model, the scan
runs in f32, and a state leaf takes the dtype the reference's arithmetic
gives it: ``conv`` is declared bf16, and a step's new ``conv`` is the
promotion of that and the input (f32 in an f32 model), as ``jnp.
concatenate`` promotes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.group import enter_split, project_out

from .layers import Params, check_chunks, dense_init, rmsnorm_split


@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    ssm_state: int = 64      # N
    head_dim: int = 64       # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    rms_eps: float = 1e-6
    # a mesh rank's spec: the heads (and d_inner) are split over this many
    # ranks, the projections' input (d_model) and B/C stay whole
    shards: int = 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model // self.shards

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_state


def mamba2_param_shapes(s: Mamba2Spec) -> Dict[str, Tuple]:
    return {
        "in_proj": (s.d_model, 2 * s.d_inner + 2 * s.ssm_state + s.num_heads),
        "conv_w": (s.conv_width, s.conv_dim),
        "conv_b": (s.conv_dim,),
        "A_log": (s.num_heads,),
        "D": (s.num_heads,),
        "dt_bias": (s.num_heads,),
        "norm": (s.d_inner,),
        "out_proj": (s.d_inner, s.d_model),
    }


def init_mamba2(gen: torch.Generator, s: Mamba2Spec, dtype: torch.dtype) -> Params:
    dev = gen.device
    conv_w = torch.randn((s.conv_width, s.conv_dim), generator=gen, device=dev)
    return {
        "in_proj": dense_init(gen, s.d_model,
                              2 * s.d_inner + 2 * s.ssm_state + s.num_heads, dtype),
        "conv_w": conv_w.div_(math.sqrt(s.conv_width)).to(dtype),
        "conv_b": torch.zeros((s.conv_dim,), dtype=dtype, device=dev),
        # A = -exp(0) = -1
        "A_log": torch.zeros((s.num_heads,), dtype=torch.float32, device=dev),
        "D": torch.ones((s.num_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((s.num_heads,), dtype=torch.float32, device=dev),
        "norm": torch.ones((s.d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, s.d_inner, s.d_model, dtype),
    }


def _project(p: Params, s: Mamba2Spec, x: torch.Tensor):
    """x: (B, S, d) -> z, xs, Bm, Cm, dt  (pre-conv split)."""
    return torch.split(x @ p["in_proj"], [s.d_inner, s.d_inner, s.ssm_state,
                                          s.ssm_state, s.num_heads], dim=-1)


def _causal_conv(s: Mamba2Spec, xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  xbc: (B, S, C).

    prev: (B, width-1, C) history for decode; returns (out, new_prev)."""
    B, S, C = xbc.shape
    W = s.conv_width
    if prev is None:
        prev = torch.zeros((B, W - 1, C), dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([prev, xbc], dim=1)          # promotes, as jnp.concatenate
    out = torch.zeros((B, S, C), dtype=xbc.dtype, device=xbc.device)
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i]
    return F.silu(out + b), xp[:, -(W - 1):, :].clone()


def _ssd_chunked(s: Mamba2Spec, xh, Bm, Cm, log_a, dt, h0):
    """Chunked SSD.  xh: (B, S, H, P); Bm/Cm: (B, S, N); log_a/dt: (B, S, H).

    h0: (B, H, P, N) initial state.  Returns (y, h_final).

    Each product is written as pairwise contractions (the reference's
    three-operand einsums, in an order that never forms a (B, c, H, P, N)
    intermediate, whether or not ``torch.einsum`` optimises the path).
    One departure, in the gradient only: the reference computes
    ``where(mask, exp(decay), 0)``, whose backward is NaN where a masked
    ``decay`` (positive above the diagonal) overflows ``exp`` — at the
    full config's chunk of 128 steps it does.  Here the masked entries are
    set to -inf before ``exp``: the forward is the same, and so is the
    gradient wherever the reference's is finite."""
    B, S, H, P = xh.shape
    c = check_chunks(S, s.chunk)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xh.device))
    h, ys = h0, []
    for i in range(0, S, c):
        xc, Bc, Cc, lac, dtc = (t[:, i:i + c] for t in (xh, Bm, Cm, log_a, dt))
        L = torch.cumsum(lac, dim=1)                         # (B, c, H) inclusive
        # intra-chunk: y_t = sum_{s<=t} exp(L_t - L_s) * (C_t.B_s) * dt_s x_s
        G = torch.einsum("btn,bsn->bts", Cc, Bc)             # (B, c, c)
        decay = L[:, :, None, :] - L[:, None, :, :]          # (B, t, s, H)
        M = torch.exp(decay.masked_fill(~mask[None, :, :, None], float("-inf")))
        Xd = xc * dtc[..., None]                             # (B, c, H, P)
        y_intra = torch.einsum("btsh,bshp->bthp", G[..., None] * M, Xd)
        # inter-chunk: y_t += exp(L_t) * C_t @ h^T
        y_inter = torch.einsum("btn,bhpn->bthp", Cc, h) * torch.exp(L)[..., None]
        # state update: h' = exp(L_c) h + sum_s exp(L_c - L_s) Xd_s outer B_s
        tail = torch.exp(L[:, -1:, :] - L)                   # (B, c, H)
        h = h * torch.exp(L[:, -1])[..., None, None] + torch.einsum(
            "bshp,bsn->bhpn", Xd * tail[..., None], Bc)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def _ssd_sequential(s: Mamba2Spec, xh, Bm, Cm, log_a, dt, h0):
    """Oracle: one step at a time."""
    h, ys = h0, []
    for t in range(xh.shape[1]):
        a = torch.exp(log_a[:, t])[..., None, None]          # (B, H, 1, 1)
        upd = torch.einsum("bhp,bn->bhpn", xh[:, t] * dt[:, t, :, None], Bm[:, t])
        h = a * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


SSD_VARIANTS = {"chunked": _ssd_chunked, "sequential": _ssd_sequential}


def mamba2_block(
    p: Params, s: Mamba2Spec, x: torch.Tensor,
    *, ssd_impl: str = "chunked", state: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d) -> (B, S, d).  state: {"h", "conv"} for decode and
    state-carrying prefill; the new state is returned (None without one)."""
    B, S, _ = x.shape
    H, P, N = s.num_heads, s.head_dim, s.ssm_state
    # on a rank whose plan splits the "mixer" block: its heads' z, x and dt
    # columns and x channels, with B and C (one group) whole on every rank,
    # whose gradients are therefore partials (sharding.GradLeaf.shared); the
    # input's gradient is summed once, here
    x = enter_split(x, "mixer")
    z, xs, Bm, Cm, dt_raw = _project(p, s, x)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    conv_prev = state["conv"] if state is not None else None
    xbc, conv_new = _causal_conv(s, xbc, p["conv_w"], p["conv_b"], conv_prev)
    xs, Bm, Cm = torch.split(xbc, [s.d_inner, N, N], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])           # (B, S, H)
    A = -torch.exp(p["A_log"])
    log_a = dt * A                                           # (B, S, H), negative
    xh = xs.reshape(B, S, H, P).float()

    h0 = (state["h"] if state is not None
          else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
    # a one-token call takes the exact recurrence; longer inputs (train and
    # chunked prefill) the selected variant, which carries h0
    impl = SSD_VARIANTS[ssd_impl if S > 1 else "sequential"]
    y, h_final = impl(s, xh, Bm.float(), Cm.float(), log_a, dt, h0)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, s.d_inner).to(x.dtype)
    # the gated norm stays one RMSNorm over the whole d_inner (the rank's
    # sum of squares summed), then out_proj's partial is summed
    y = rmsnorm_split(y * F.silu(z), p["norm"], s.rms_eps, "mixer")
    out = project_out(y, p["out_proj"], "mixer")
    new_state = {"h": h_final, "conv": conv_new} if state is not None else None
    return out, new_state


def mamba2_state_specs(s: Mamba2Spec, batch: int
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each state leaf, as the reference declares them."""
    return {
        "h": ((batch, s.num_heads, s.head_dim, s.ssm_state), torch.float32),
        "conv": ((batch, s.conv_width - 1, s.conv_dim), torch.bfloat16),
    }


def init_mamba2_state(s: Mamba2Spec, batch: int, dtype=torch.bfloat16, *,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, s.num_heads, s.head_dim, s.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, s.conv_dim), dtype=dtype,
                            device=device),
    }
