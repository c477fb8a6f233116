"""The plain pieces every family's reference shares, written from the
equations in plain PyTorch: products, RMSNorm, RoPE, causal GQA attention
and the attention half of a decoder layer, a decoder's serving logits and
next-token loss around a family's layer, AdamW, its schedule and the
training steps.

Everything runs in f32 with TF32 off.  ``precision="fp8"`` is the control:
both operands of every weight product rounded to ``float8_e4m3fn`` (one
scale a tensor, its absolute maximum over 448), the step below bf16 that a
later change could be tempted to take.

Conventions the port shares: weights are (d_in, d_out), so a product is
``x @ W``; RoPE rotates interleaved pairs ``x[..., 0::2]``, ``x[..., 1::2]``;
RMSNorm is ``x / sqrt(mean(x^2) + eps) * gain``.  Parameters are a flat dict
of ``path -> tensor`` (:func:`portbench.weights.flatten`), any dtype: each
layer's weights are cast to f32 as the layer runs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0
LAYERS = "layers/"


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale a tensor, back in f32; the
    gradient passes straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return fp8_round(x) @ fp8_round(w)
    return x @ w


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * gain


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (H, S, D) rotated pairwise by position * theta^(-2i/D)."""
    D = x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).reshape(x.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int],
              rows: int = 1024) -> torch.Tensor:
    """Causal GQA softmax attention in f32, ``rows`` queries at a time.
    q (Hq, S, D), k/v (Hkv, T, D), positions absolute."""
    Hq, S, D = q.shape
    Hkv = k.shape[0]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    kq = k.repeat_interleave(g, dim=0)
    vq = v.repeat_interleave(g, dim=0)
    out = []
    for s0 in range(0, S, rows):
        qi = q[:, s0:s0 + rows]
        pi = q_pos[s0:s0 + rows]
        scores = (qi @ kq.transpose(1, 2)) * scale
        keep = k_pos[None, :] <= pi[:, None]
        if window is not None:
            keep = keep & (k_pos[None, :] > pi[:, None] - window)
        scores = scores.masked_fill(~keep[None], float("-inf"))
        out.append(torch.softmax(scores, dim=-1) @ vq)
    return torch.cat(out, dim=1)


def attention_block(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                    positions: torch.Tensor, precision: str) -> torch.Tensor:
    """x (S, d) in f32 plus its attention half: RMSNorm, the q/k/v
    projections, per-head q/k RMSNorm where ``cfg.qk_norm``, RoPE, causal
    GQA attention (within ``cfg.window``), the output projection."""
    S = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rmsnorm(x, p["ln1"], cfg.rms_eps)
    q = linear(h, p["attn_wq"], precision).reshape(S, hq, hd).transpose(0, 1)
    k = linear(h, p["attn_wk"], precision).reshape(S, hkv, hd).transpose(0, 1)
    v = linear(h, p["attn_wv"], precision).reshape(S, hkv, hd).transpose(0, 1)
    if cfg.qk_norm:
        q = rmsnorm(q, p["attn_q_norm"], cfg.rms_eps)
        k = rmsnorm(k, p["attn_k_norm"], cfg.rms_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, positions, positions, cfg.window)
    return x + linear(o.transpose(0, 1).reshape(S, hq * hd), p["attn_wo"], precision)


Layer = Callable[..., torch.Tensor]


def layer_params(params: Dict[str, torch.Tensor], l: int) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s weights in f32 (a copy; the stacks keep their dtype)."""
    return {k[len(LAYERS):]: v[l].to(torch.float32)
            for k, v in params.items() if k.startswith(LAYERS)}


def decoder_logits(layer: Layer, cfg, params: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, start: int, precision: str) -> torch.Tensor:
    """Logits (S - start, V) in f32 of positions ``start`` .. S - 1 of one
    sequence ``tokens`` (S,) through ``cfg.num_layers`` of ``layer(cfg, p,
    x, positions, precision)``: row j predicts the token after position
    ``start + j``.  One layer's f32 weights live at a time."""
    with strict_f32(), torch.no_grad():
        dev = tokens.device
        x = params["embed"][tokens.long()].to(torch.float32)
        positions = torch.arange(tokens.shape[0], device=dev)
        for l in range(cfg.num_layers):
            x = layer(cfg, layer_params(params, l), x, positions, precision)
        h = rmsnorm(x[start:], params["final_norm"].to(torch.float32), cfg.rms_eps)
        return linear(h, params["lm_head"].to(torch.float32), precision)


def decoder_loss(layer: Layer, cfg, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 labels: torch.Tensor, precision: str, remat: bool) -> torch.Tensor:
    """Mean next-token cross-entropy over every position of every row of
    ``tokens`` (B, S) through ``cfg.num_layers`` of ``layer``, params f32
    leaves (autograd through them); each layer recomputed in the backward
    pass when ``remat``."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    total = 0.0
    for b in range(B):
        x = F.embedding(tokens[b].long(), params["embed"])
        for l in range(cfg.num_layers):
            p = {k[len(LAYERS):]: v[l] for k, v in params.items() if k.startswith(LAYERS)}
            if remat:
                x = checkpoint(layer, cfg, p, x, positions, precision,
                               use_reentrant=False)
            else:
                x = layer(cfg, p, x, positions, precision)
        h = rmsnorm(x, params["final_norm"], cfg.rms_eps)
        logits = linear(h, params["lm_head"], precision)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[b].long()[:, None])[:, 0]
        total = total + torch.sum(logz - gold)
    return total / (B * S)


def warmup_cosine(step: int, peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> float:
    """Linear warmup from 0, then cosine decay to ``min_ratio`` of the peak."""
    if step < warmup_steps:
        return peak_lr * step / max(warmup_steps, 1)
    frac = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
    return peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))


def adamw_step(params, grads, m, v, step: int, lr: float, opt: dict,
               clip_scale: float, piece: int = 1 << 24) -> None:
    """One decoupled-weight-decay Adam step in place, every tensor f32:
    the gradient scaled by ``clip_scale`` first; ``step`` counts from 1.
    Each leaf goes in slices of about ``piece`` elements along its leading
    axis, and its gradient is dropped from ``grads`` once applied, so the
    step holds no second copy of anything."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    with torch.no_grad():
        for k in list(grads):
            g_all = grads.pop(k)
            rows = max(1, piece // max(1, g_all[0].numel())) if g_all.ndim else 1
            parts = (zip(params[k].split(rows), g_all.split(rows), m[k].split(rows),
                         v[k].split(rows)) if g_all.ndim else
                     [(params[k], g_all, m[k], v[k])])
            for p, g, mm, vv in parts:
                g = g * clip_scale
                mm.mul_(b1).add_(g, alpha=1 - b1)
                vv.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mm / (1 - b1 ** step)).div_((vv / (1 - b2 ** step)).sqrt_().add_(eps))
                p.sub_(upd.add_(p, alpha=wd).mul_(lr))
            del g_all


def train(loss: Callable[..., torch.Tensor], cfg, params: Dict[str, torch.Tensor],
          batches, opt: dict, schedule: dict, precision: str = "f32",
          half_rows: bool = False) -> dict:
    """``len(batches)`` training steps of a family's ``loss(cfg, params,
    tokens, labels, precision)`` from ``params`` (f32 leaves, updated in
    place).  Returns each step's loss, the first step's per-leaf gradient
    norms (before the clip) and each step's global gradient norm.
    ``half_rows`` is a planted fault: each loss takes the mean over the first
    half of its positions only."""
    with strict_f32():
        m = {k: torch.zeros_like(t) for k, t in params.items()}
        v = {k: torch.zeros_like(t) for k, t in params.items()}
        keys = list(params)
        out = {"loss": [], "grad_norm": [], "first_grad_norms": {}}
        for i, (tokens, labels) in enumerate(batches):
            if half_rows:
                half = tokens.shape[1] // 2
                tokens, labels = tokens[:, :half], labels[:, :half]
            leaves = [params[k].requires_grad_(True) for k in keys]
            with torch.enable_grad():
                lval = loss(cfg, params, tokens, labels, precision)
                grads = torch.autograd.grad(lval, leaves)
            for t in leaves:
                t.requires_grad_(False)
            grads = dict(zip(keys, grads))
            norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            gn = math.sqrt(sum(n * n for n in norms.values()))
            out["loss"].append(float(lval.detach()))
            out["grad_norm"].append(gn)
            if i == 0:
                out["first_grad_norms"] = norms
            lr = warmup_cosine(i, schedule["peak_lr"], schedule["warmup_steps"],
                               schedule["total_steps"])
            clip = min(1.0, opt["grad_clip"] / (gn + 1e-9)) if opt["grad_clip"] else 1.0
            adamw_step(params, grads, m, v, i + 1, lr, opt, clip)
            del grads, lval
        del m, v
    return out
