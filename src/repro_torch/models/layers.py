"""Shared neural blocks: norms, RoPE, attention, GQA projections, FFN,
initialisers.

Plain functions over parameter dicts of tensors, as in ``repro.models.
layers``.  Weights keep the reference's ``(d_in, d_out)`` orientation, so
``x @ W`` means the same on both sides and converted parameters need no
transpose.  Numerics follow the reference step by step: RoPE rotates
interleaved pairs ``x[..., 0::2]``/``x[..., 1::2]``, and ``rmsnorm`` casts
back to the input dtype *before* the gamma multiply.  Attention is a VPE
op with two variants (``ATTENTION_VARIANTS``): ``reference``, the
q-chunked softmax in plain PyTorch, and ``flash_cuda``, the forward flash
kernel whose backward runs through the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref as kref

Params = Dict[str, Any]


# -- initializers ------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/d_in) weights drawn on ``gen``'s device (f32, then cast)."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


# -- norms -------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


# -- RoPE --------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, D) rotated by per-position angles; positions: (S,) or (B, S)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, device=x.device)               # (D/2,)
    if positions.ndim == 1:
        ang = (positions[:, None].float() * freqs[None, :])[None, None]
    else:
        ang = positions[:, None, :, None].float() * freqs[None, None, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# -- attention (reference: q-chunked softmax) ----------------------------------

def attention_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool = True, window: Optional[int] = None,
    scale: Optional[float] = None, q_chunk: int = 1024,
) -> torch.Tensor:
    """Attention in plain PyTorch, one q chunk at a time.

    q: (B, Hq, S, D); k/v: (B, Hkv, T, D).  Up to ``q_chunk`` rows it is
    :func:`kref.attention_ref`; past that the rows go in chunks of the
    largest size that divides S, each scored against all T columns in f32
    (peak O(q_chunk * T) logits), with the probabilities rounded to v's
    dtype before the value product, as ``repro.models.layers.
    attention_chunked`` does.  Grouped heads are scored in place (no
    repeat of K/V).
    """
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if S <= q_chunk:
        return kref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    while S % q_chunk:  # largest chunk that divides S (e.g. 1500 -> 750)
        q_chunk -= 1
    offset = T - S
    qg = q.reshape(B, Hkv, group, S, D)
    kf, vf = k.float(), v.float()
    col = torch.arange(T, device=q.device)[None, :]
    outs = []
    for start in range(0, S, q_chunk):
        qi = qg[:, :, :, start:start + q_chunk].float()
        s = torch.einsum("bhgsd,bhtd->bhgst", qi, kf) * scale
        row = start + torch.arange(q_chunk, device=q.device)[:, None] + offset
        mask = torch.ones((q_chunk, T), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (col <= row)
        if window is not None:
            mask = mask & (col > row - window)
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhgst,bhtd->bhgsd", p.to(v.dtype).float(),
                                 vf).to(q.dtype))
    return torch.cat(outs, dim=3).reshape(B, Hq, S, D)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash kernel (its plain version on the CPU).  Backward:
    the VJP of :func:`attention_chunked`, recomputed from the saved q, k, v
    — ``repro.models.layers._flash_cvjp_bwd`` line for line (the JAX
    package has no backward kernel either)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, scale)
        return kflash.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, scale=scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale = ctx.opts
        with torch.enable_grad(), record_function("attention_flash.backward"):
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = attention_chunked(q, k, v, causal=causal, window=window,
                                    scale=scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def attention_flash(q, k, v, *, causal=True, window=None, scale=None):
    """Flash kernel variant: :func:`kflash.flash_attention_cuda` forward,
    reference backward."""
    return _FlashAttention.apply(q, k, v, causal, window, scale)


ATTENTION_VARIANTS = {
    "reference": attention_chunked,
    "flash_cuda": attention_flash,
}


# -- GQA attention projections -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None
    rope_theta: float = 1e4
    rms_eps: float = 1e-6


def attn_param_shapes(s: AttnSpec) -> Dict[str, Tuple]:
    shapes = {
        "wq": (s.d_model, s.num_heads * s.head_dim),
        "wk": (s.d_model, s.num_kv_heads * s.head_dim),
        "wv": (s.d_model, s.num_kv_heads * s.head_dim),
        "wo": (s.num_heads * s.head_dim, s.d_model),
    }
    if s.qkv_bias:
        shapes.update({
            "bq": (s.num_heads * s.head_dim,),
            "bk": (s.num_kv_heads * s.head_dim,),
            "bv": (s.num_kv_heads * s.head_dim,),
        })
    if s.qk_norm:
        shapes.update({"q_norm": (s.head_dim,), "k_norm": (s.head_dim,)})
    return shapes


def init_attn(gen: torch.Generator, s: AttnSpec, dtype: torch.dtype) -> Params:
    dev = gen.device
    p: Params = {
        "wq": dense_init(gen, s.d_model, s.num_heads * s.head_dim, dtype),
        "wk": dense_init(gen, s.d_model, s.num_kv_heads * s.head_dim, dtype),
        "wv": dense_init(gen, s.d_model, s.num_kv_heads * s.head_dim, dtype),
        "wo": dense_init(gen, s.num_heads * s.head_dim, s.d_model, dtype),
    }
    if s.qkv_bias:
        p["bq"] = torch.zeros((s.num_heads * s.head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((s.num_kv_heads * s.head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((s.num_kv_heads * s.head_dim,), dtype=dtype, device=dev)
    if s.qk_norm:
        p["q_norm"] = torch.ones((s.head_dim,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((s.head_dim,), dtype=dtype, device=dev)
    return p


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, d).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def attn_qkv(p: Params, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor):
    """Project + rope; returns q (B,H,S,D), k/v (B,Hkv,S,D).  q and k come
    out contiguous (RoPE builds them anew); v is a transposed view."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if s.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, s.num_heads, s.head_dim)
    k = _split_heads(k, s.num_kv_heads, s.head_dim)
    v = _split_heads(v, s.num_kv_heads, s.head_dim)
    if s.qk_norm:
        q = rmsnorm(q, p["q_norm"], s.rms_eps)
        k = rmsnorm(k, p["k_norm"], s.rms_eps)
    q = apply_rope(q, positions, s.rope_theta)
    k = apply_rope(k, positions, s.rope_theta)
    return q, k, v


def attn_block(
    p: Params, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor,
    *, causal: bool = True, attn_impl: str = "reference",
) -> torch.Tensor:
    """Full attention sub-layer (projections + attention + output proj)."""
    q, k, v = attn_qkv(p, s, x, positions)
    o = ATTENTION_VARIANTS[attn_impl](q, k, v, causal=causal, window=s.window)
    return _merge_heads(o) @ p["wo"]


# -- FFN -----------------------------------------------------------------------

def swiglu_param_shapes(d_model: int, d_ff: int) -> Dict[str, Tuple]:
    return {
        "w_gate": (d_model, d_ff),
        "w_up": (d_model, d_ff),
        "w_down": (d_ff, d_model),
    }


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype) -> Params:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
