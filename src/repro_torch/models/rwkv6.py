"""RWKV6 ("Finch") block — attention-free, data-dependent decay.

The counterpart of ``repro.models.rwkv6``, step for step; the reference
computes the WKV scan outside any Pallas kernel, so it is plain PyTorch
here too.  Time-mix (WKV6) per head (key dim K, value dim V, K = V):

    out_t = r_t @ (S_{t-1} + (u ⊙ k_t) v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T          w_t ∈ (0,1) per channel

with w_t data-dependent through a low-rank projection.  Channel-mix:
r ⊙ (relu(k)² W_v).  Token shift mixes x_t with x_{t-1}.

Variants of the ``wkv`` op (``WKV_VARIANTS``):
  * ``sequential`` — one step at a time (the oracle, and what a one-token
    call takes whatever ``wkv_impl`` says);
  * ``chunked`` — the log-space chunked form (dense products a chunk).
    ``exp(-Lw)`` grows across a chunk; the reference's formulation and its
    f32 are kept.

``w_base``, ``w_lora_a``, ``w_lora_b`` and ``u`` are f32 leaves in a bf16
model; the token-shift state leaves are declared bf16 and take the dtype
of the input after a step (f32 in an f32 model), as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.group import enter_split, project_out

from .layers import Params, check_chunks, dense_init, rmsnorm_split


@dataclasses.dataclass(frozen=True)
class RWKV6Spec:
    d_model: int
    d_ff: int
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 32
    rms_eps: float = 1e-6
    # a mesh rank's spec: the time-mix heads are split over this many
    # ranks, the projections' input (d_model) stays whole
    shards: int = 1

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim // self.shards

    @property
    def d_mix(self) -> int:
        """The time-mix width a rank holds: its heads times the head dim."""
        return self.num_heads * self.head_dim


def rwkv6_param_shapes(s: RWKV6Spec) -> Dict[str, Tuple]:
    d, h = s.d_model, s.d_mix
    return {
        # time-mix
        "mix_r": (d,), "mix_k": (d,), "mix_v": (d,), "mix_w": (d,), "mix_g": (d,),
        "wr": (d, h), "wk": (d, h), "wv": (d, h), "wg": (d, h), "wo": (h, d),
        "w_base": (h,),
        "w_lora_a": (d, s.decay_lora), "w_lora_b": (s.decay_lora, h),
        "u": (h,),
        "ln_x": (h,),
        # channel-mix
        "cmix_r": (d,), "cmix_k": (d,),
        "cr": (d, d), "ck": (d, s.d_ff), "cv": (s.d_ff, d),
    }


def init_rwkv6(gen: torch.Generator, s: RWKV6Spec, dtype: torch.dtype) -> Params:
    d = s.d_model
    dev = gen.device

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=dev)

    f32 = torch.float32
    return {
        "mix_r": half(), "mix_k": half(), "mix_v": half(), "mix_w": half(),
        "mix_g": half(),
        "wr": dense_init(gen, d, d, dtype), "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype), "wg": dense_init(gen, d, d, dtype),
        "wo": dense_init(gen, d, d, dtype),
        "w_base": torch.full((d,), -2.0, dtype=f32, device=dev),
        "w_lora_a": dense_init(gen, d, s.decay_lora, f32),
        "w_lora_b": torch.randn((s.decay_lora, d), generator=gen, device=dev).mul_(0.01),
        "u": torch.randn((d,), generator=gen, device=dev).mul_(0.1),
        "ln_x": torch.ones((d,), dtype=dtype, device=dev),
        "cmix_r": half(), "cmix_k": half(),
        "cr": dense_init(gen, d, d, dtype),
        "ck": dense_init(gen, d, s.d_ff, dtype),
        "cv": dense_init(gen, s.d_ff, d, dtype),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """shift(x)_t = x_{t-1}; prev: (B, d) carried state for decode.  Returns
    (shifted, the last position: the next call's ``prev``)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1, :])
    else:
        prev = prev[:, None, :]
    shifted = torch.cat([prev, x[:, :-1, :]], dim=1)   # promotes, as jnp.concatenate
    return shifted, x[:, -1, :].clone()


def _heads(x: torch.Tensor, H: int, D: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, H, D)


def _wkv_sequential(r, k, v, w, u, S0):
    """r/k/w: (B, T, H, K); v: (B, T, H, V); u: (H, K); S0: (B, H, K, V)."""
    S, outs = S0, []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 S + u[None, :, :, None] * kv))
        S = w[:, t][..., None] * S + kv
    return torch.stack(outs, dim=1), S                      # (B, T, H, V)


def _wkv_chunked(r, k, v, w, u, S0, *, chunk: int):
    """Chunked WKV in log space.

    Within a chunk:  out_t = r_t @ (Πw<t ⊙ S_in) + Σ_{s<t} (r_t ⊙ Π_{s<i<t} w_i)·k_s v_s
                     + (r_t ⊙ u) · k_t v_t
    using  Π_{s<i<t} w_i = exp(Lw_{t-1} - Lw_s)  with Lw = cumsum(log w).
    """
    B, T, H, K = r.shape
    c = check_chunks(T, chunk)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    S, outs = S0, []
    for i in range(0, T, c):
        rc, kc, vc, wc = (t[:, i:i + c] for t in (r, k, v, w))   # (B, c, H, K)
        lw = torch.log(wc)                                       # negative
        Lw = torch.cumsum(lw, dim=1)                             # inclusive
        # inter: out_t += (r_t ⊙ exp(Lw_{t-1})) @ S   (Lw_{t-1} = Lw_t - lw_t)
        r_decay = rc * torch.exp(Lw - lw)
        out = torch.einsum("bthk,bhkv->bthv", r_decay, S)
        # intra (s < t): A[t,s] = Σ_k r_t,k exp(Lw_{t-1,k} - Lw_{s,k}) k_s,k
        A = torch.einsum("bthk,bshk->bhts", r_decay, kc * torch.exp(-Lw))
        A = torch.where(mask[None, None], A, 0.0)
        out = out + torch.einsum("bhts,bshv->bthv", A, vc)
        # diagonal bonus
        out = out + (rc * u[None, None] * kc).sum(-1, keepdim=True) * vc
        # state update: S' = exp(Lw_c) ⊙ S + Σ_s exp(Lw_c - Lw_s) k_s v_s
        tail = torch.exp(Lw[:, -1:] - Lw)                        # (B, c, H, K)
        S = S * torch.exp(Lw[:, -1])[..., None] + torch.einsum(
            "bshk,bshv->bhkv", kc * tail, vc)
        outs.append(out)
    return torch.cat(outs, dim=1), S


WKV_VARIANTS = {"sequential": _wkv_sequential, "chunked": _wkv_chunked}


def rwkv6_time_mix(
    p: Params, s: RWKV6Spec, x: torch.Tensor,
    *, wkv_impl: str = "chunked", state: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """On a rank whose plan splits the ``"mixer"`` block, over its heads:
    the input's gradient is summed over the model group once, at the
    entry (so ``mix_*`` and ``w_lora_a``, read before the split, get a
    partial gradient on each rank), ``ln_x`` stays a norm over the whole
    row and ``wo``'s partial is summed."""
    B, T, _ = x.shape
    H, K = s.num_heads, s.head_dim
    x = enter_split(x, "mixer")
    prev = state["x_tm"] if state is not None else None
    xs, last_x = _token_shift(x, prev)

    def mix(mu):
        return x + mu * (xs - x)

    r = _heads(mix(p["mix_r"]) @ p["wr"], H, K).float()
    k = _heads(mix(p["mix_k"]) @ p["wk"], H, K).float()
    v = _heads(mix(p["mix_v"]) @ p["wv"], H, K).float()
    g = mix(p["mix_g"]) @ p["wg"]
    xw = mix(p["mix_w"]).float()
    w_log = p["w_base"] + (xw @ p["w_lora_a"]) @ p["w_lora_b"]    # (B, T, d)
    w = _heads(torch.exp(-torch.exp(w_log)), H, K)                # (0, 1)
    u = p["u"].reshape(H, K)

    S0 = (state["S"] if state is not None
          else torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device))
    impl = WKV_VARIANTS[wkv_impl if T > 1 else "sequential"]
    kw = {"chunk": s.chunk} if impl is _wkv_chunked else {}
    out, S_final = impl(r, k, v, w, u, S0, **kw)

    out = out.reshape(B, T, s.d_mix).to(x.dtype)
    # stands in for per-head groupnorm; over the whole row, as the reference
    # (a rank's channels are its heads': the sum of squares is summed)
    out = rmsnorm_split(out, p["ln_x"], s.rms_eps, "mixer")
    out = project_out(out * F.silu(g), p["wo"], "mixer")
    new_state = {"x_tm": last_x, "S": S_final} if state is not None else None
    return out, new_state


def rwkv6_channel_mix(
    p: Params, s: RWKV6Spec, x: torch.Tensor, state: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    prev = state["x_cm"] if state is not None else None
    xs, last_x = _token_shift(x, prev)
    xr = x + p["cmix_r"] * (xs - x)
    # on a rank whose plan splits the "ffn" block: ck's columns and cv's
    # rows, the partial summed; cr stays whole (its sigmoid multiplies the
    # completed sum), so only the key's input gradient is summed
    xk = enter_split(x + p["cmix_k"] * (xs - x), "ffn")
    r = torch.sigmoid(xr @ p["cr"])
    k = torch.square(F.relu(xk @ p["ck"]))
    out = r * project_out(k, p["cv"], "ffn")
    new_state = {"x_cm": last_x} if state is not None else None
    return out, new_state


def rwkv6_state_specs(s: RWKV6Spec, batch: int
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each state leaf, as the reference declares them."""
    return {
        "x_tm": ((batch, s.d_model), torch.bfloat16),
        "x_cm": ((batch, s.d_model), torch.bfloat16),
        "S": ((batch, s.num_heads, s.head_dim, s.head_dim), torch.float32),
    }


def init_rwkv6_state(s: RWKV6Spec, batch: int, dtype=torch.bfloat16, *,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    return {
        "x_tm": torch.zeros((batch, s.d_model), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, s.d_model), dtype=dtype, device=device),
        "S": torch.zeros((batch, s.num_heads, s.head_dim, s.head_dim),
                         dtype=torch.float32, device=device),
    }
