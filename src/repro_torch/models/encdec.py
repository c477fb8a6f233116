"""Whisper-style encoder-decoder (family: encdec; whisper-base).

The counterpart of ``repro.models.encdec``.  As in the reference, the
audio frontend is a stub: the model takes precomputed frame embeddings
(B, source_len, d_model) in the model's dtype; RMSNorm stands in for
LayerNorm, RoPE for the decoder's learned positions — and is applied to
the cross-attention's q and k too (``attn_qkv`` with positions) — and the
MLPs are GELU (the tanh form, as ``jax.nn.gelu``'s default).

Attention runs through ``ATTENTION_VARIANTS[attn_impl or cfg.attn_impl]``
three times a layer pair: the encoder's non-causal self-attention, the
decoder's causal self-attention and its non-causal cross-attention (S
decoder rows against the T source frames; S may exceed T).  Under
``flash_cuda`` that is one flash launch each.  The training passes
recompute each layer in the backward pass under ``cfg.remat == "full"``.

Serving: :func:`precompute_cross_kv` fills the cross K/V once a request,
cast to bf16 whatever the model's dtype (so an f32 model's decode reads
rounded cross K/V where :func:`decode_train` does not, as in the
reference); :func:`decode_step` writes the self-attention K/V in place and
reads the cross K/V through ``decode_attention`` at length
``source_len - 1`` (every frame).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.group import gather_params, project_out

from . import kvcache, layers
from .layers import AttnSpec, Params
from .transformer import _dtype, _sub


def attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
    )


def _enc_layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    d = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    d.update({f"attn_{k}": v for k, v in layers.attn_param_shapes(attn_spec(cfg)).items()})
    d.update({f"mlp_{k}": v for k, v in
              layers.gelu_mlp_param_shapes(cfg.d_model, cfg.d_ff).items()})
    return d


def _dec_layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    s = attn_spec(cfg)
    d = {"ln1": (cfg.d_model,), "ln_x": (cfg.d_model,), "ln2": (cfg.d_model,)}
    d.update({f"attn_{k}": v for k, v in layers.attn_param_shapes(s).items()})
    d.update({f"xattn_{k}": v for k, v in layers.attn_param_shapes(s).items()})
    d.update({f"mlp_{k}": v for k, v in
              layers.gelu_mlp_param_shapes(cfg.d_model, cfg.d_ff).items()})
    return d


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": (cfg.vocab_size, cfg.d_model),
        "enc_norm": (cfg.d_model,),
        "dec_norm": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab_size),
        "encoder": {k: (cfg.encoder_layers, *v) for k, v in _enc_layer_shapes(cfg).items()},
        "decoder": {k: (cfg.decoder_layers, *v) for k, v in _dec_layer_shapes(cfg).items()},
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, keep=None) -> Params:
    """Random parameters on ``gen``'s device: the reference's distributions
    and dtypes, not its numbers.  ``keep(path, leaf)`` replaces each leaf
    as it is drawn (``layers.keep_leaves``)."""
    dt = _dtype(cfg)
    dev = gen.device
    s = attn_spec(cfg)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dt, device=dev)

    def enc_one():
        p = {"ln1": ones(), "ln2": ones()}
        p.update({f"attn_{n}": v for n, v in layers.init_attn(gen, s, dt).items()})
        p.update({f"mlp_{n}": v for n, v in
                  layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt).items()})
        return layers.keep_leaves(keep, "['encoder']", p)

    def dec_one():
        p = {"ln1": ones(), "ln_x": ones(), "ln2": ones()}
        p.update({f"attn_{n}": v for n, v in layers.init_attn(gen, s, dt).items()})
        p.update({f"xattn_{n}": v for n, v in layers.init_attn(gen, s, dt).items()})
        p.update({f"mlp_{n}": v for n, v in
                  layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt).items()})
        return layers.keep_leaves(keep, "['decoder']", p)

    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev)
    return layers.keep_leaves(keep, "", {
        "embed": embed.mul_(0.02).to(dt),
        "enc_norm": ones(),
        "dec_norm": ones(),
        "lm_head": layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt),
    }) | {
        "encoder": layers.stack_layers((cfg.encoder_layers,), enc_one),
        "decoder": layers.stack_layers((cfg.decoder_layers,), dec_one),
    }


def _enc_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
               positions: torch.Tensor, impl: str) -> torch.Tensor:
    lp = gather_params(lp, "['encoder']")
    h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
    x = x + layers.attn_block(_sub(lp, "attn_"), attn_spec(cfg), h, positions,
                              causal=False, attn_impl=impl)
    h = layers.rmsnorm(x, lp["ln2"], cfg.rms_eps)
    return x + layers.gelu_mlp(_sub(lp, "mlp_"), h)


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor,
           attn_impl: Optional[str] = None) -> torch.Tensor:
    """frames: (B, T_src, d) stubbed frame embeddings in the model's dtype
    -> (B, T_src, d)."""
    if frames.dtype != params["enc_norm"].dtype:
        raise TypeError(f"frames are {frames.dtype}, the model "
                        f"{params['enc_norm'].dtype}: pass frames in the "
                        f"model's dtype")
    positions = torch.arange(frames.shape[1], device=frames.device)
    impl = attn_impl or cfg.attn_impl
    x = frames
    for lp in layers.unstack_layers(params["encoder"], cfg.encoder_layers):
        x = layers.remat(cfg, _enc_layer, cfg, lp, x, positions, impl)
    return layers.rmsnorm(x, layers.leaf(params, "enc_norm"), cfg.rms_eps)


def _dec_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, enc_out: torch.Tensor,
               positions: torch.Tensor, enc_positions: torch.Tensor,
               impl: str) -> torch.Tensor:
    s = attn_spec(cfg)
    lp = gather_params(lp, "['decoder']")
    h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
    x = x + layers.attn_block(_sub(lp, "attn_"), s, h, positions, causal=True,
                              attn_impl=impl)
    # cross attention: q from the decoder, k/v from the encoder output
    h = layers.rmsnorm(x, lp["ln_x"], cfg.rms_eps)
    xp = _sub(lp, "xattn_")
    q, _, _ = layers.attn_qkv(xp, s, h, positions)
    _, k, v = layers.attn_qkv(xp, s, enc_out, enc_positions)
    o = layers.ATTENTION_VARIANTS[impl](q, k, v, causal=False)
    x = x + project_out(layers._merge_heads(o), xp["wo"], "attn")
    h = layers.rmsnorm(x, lp["ln2"], cfg.rms_eps)
    return x + layers.gelu_mlp(_sub(lp, "mlp_"), h)


def decode_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 enc_out: torch.Tensor, attn_impl: Optional[str] = None
                 ) -> torch.Tensor:
    """tokens (B, S) against enc_out (B, T_src, d) -> logits (B, S, V) f32."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    enc_positions = torch.arange(enc_out.shape[1], device=tokens.device)
    impl = attn_impl or cfg.attn_impl
    x = F.embedding(tokens.long(), layers.leaf(params, "embed"))
    for lp in layers.unstack_layers(params["decoder"], cfg.decoder_layers):
        x = layers.remat(cfg, _dec_layer, cfg, lp, x, enc_out, positions,
                         enc_positions, impl)
    x = layers.rmsnorm(x, layers.leaf(params, "dec_norm"), cfg.rms_eps)
    return (x @ layers.leaf(params, "lm_head")).float()


def forward(cfg: ModelConfig, params: Params, frames: torch.Tensor,
            tokens: torch.Tensor, attn_impl: Optional[str] = None) -> torch.Tensor:
    return decode_train(cfg, params, tokens,
                        encode(cfg, params, frames, attn_impl), attn_impl)


# -- serving ------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Dict[str, Any]:
    """The decoder's bf16 self-attention cache and the bf16 cross K/V
    (L_dec, B, Hkv, source_len, D)."""
    kv = kvcache.init_kv_cache(cfg.decoder_layers, batch, cfg.num_kv_heads,
                               max_len, cfg.head_dim, device=device)
    xshape = (cfg.decoder_layers, batch, cfg.num_kv_heads, cfg.source_len,
              cfg.head_dim)
    return {**kv,
            "xk": torch.zeros(xshape, dtype=torch.bfloat16, device=device),
            "xv": torch.zeros(xshape, dtype=torch.bfloat16, device=device)}


def precompute_cross_kv(cfg: ModelConfig, params: Params, enc_out: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention K/V of every decoder layer, once a request, in
    bf16: (L_dec, B, Hkv, T_src, D) each."""
    s = attn_spec(cfg)
    enc_positions = torch.arange(enc_out.shape[1], device=enc_out.device)
    ks, vs = [], []
    for l in range(cfg.decoder_layers):
        lp = gather_params({k: v[l] for k, v in params["decoder"].items()},
                           "['decoder']")
        _, k, v = layers.attn_qkv(_sub(lp, "xattn_"), s, enc_out, enc_positions)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    return torch.stack(ks), torch.stack(vs)


def decode_step(cfg: ModelConfig, params: Params, cache: Dict,
                tokens: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """One lockstep decode step; tokens (B, 1).  Returns (cache, logits
    (B, 1, V))."""
    s = attn_spec(cfg)
    B = tokens.shape[0]
    length = cache["length"]
    positions = length.expand(B)[:, None]
    src_last = torch.full((), cfg.source_len - 1, dtype=torch.int32,
                          device=tokens.device)
    x = layers.leaf(params, "embed")[tokens.long()]
    for l in range(cfg.decoder_layers):
        lp = gather_params({k: v[l] for k, v in params["decoder"].items()},
                           "['decoder']")
        h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = layers.attn_qkv(_sub(lp, "attn_"), s, h, positions)
        kc, vc = cache["k"][l], cache["v"][l]
        kvcache.update_layer_cache(kc, vc, k, v, length)
        o = kvcache.decode_attention(q, kc, vc, length)
        x = x + project_out(layers._merge_heads(o), lp["attn_wo"], "attn")
        h = layers.rmsnorm(x, lp["ln_x"], cfg.rms_eps)
        xp = _sub(lp, "xattn_")
        q, _, _ = layers.attn_qkv(xp, s, h, positions)
        o = kvcache.decode_attention(q, cache["xk"][l], cache["xv"][l], src_last)
        x = x + project_out(layers._merge_heads(o), xp["wo"], "attn")
        h = layers.rmsnorm(x, lp["ln2"], cfg.rms_eps)
        x = x + layers.gelu_mlp(_sub(lp, "mlp_"), h)
    x = layers.rmsnorm(x, layers.leaf(params, "dec_norm"), cfg.rms_eps)
    return {**cache, "length": length + 1}, (x @ layers.leaf(params, "lm_head")).float()
