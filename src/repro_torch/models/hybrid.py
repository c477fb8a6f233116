"""zamba2-style hybrid (family: hybrid): a Mamba2 backbone and ONE shared
attention block.

The counterpart of ``repro.models.hybrid``.  Structure (``cfg.num_layers``
blocks in order, period ``attn_every``):

    num_macro = num_layers // attn_every      macro blocks, each =
        (attn_every - 1) mamba2 layers + 1 application of the SHARED
        attention+MLP block (one weight set, applied num_macro times)
    tail = num_layers - num_macro * attn_every  extra mamba2 layers

zamba2-1.2b (38 blocks, attn_every=6): 6 macros of (5 mamba + shared
attention) and a 2-layer mamba tail.  As in the reference, the shared
block reads the residual stream only.  ``params["macro"]`` stacks the
macro layers on (num_macro, per) axes, ``params["tail"]`` on (tail,), and
the steps walk them in Python loops where the reference scans.

The training forward recomputes each macro body and each tail layer in
the backward pass (``cfg.remat == "full"``, non-reentrant
``torch.utils.checkpoint``); the shared block's weights are used once a
macro, and autograd sums their gradient over the applications.  The
serving cache has one KV layer a shared-block application; decode reads
it through :func:`kvcache.decode_attention`, and prefill runs
``ATTENTION_VARIANTS[cfg.attn_impl]`` (``flash_cuda`` launches the flash
kernel once a macro).  K/V are written into the given cache in place; the
recurrent states and the length come back in the returned cache, in the
dtypes the reference's arithmetic gives them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.group import gather_params, project_out

from . import kvcache, layers, mamba2
from .layers import Params
from .transformer import _dtype, _sub, attn_spec


def m2_spec(cfg: ModelConfig) -> mamba2.Mamba2Spec:
    """The block's spec; a mesh rank's config (``ShardConfig``) gives its
    share of the heads."""
    return mamba2.Mamba2Spec(
        d_model=cfg.d_model,
        ssm_state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand,
        conv_width=cfg.ssm_conv,
        chunk=cfg.ssm_chunk,
        rms_eps=cfg.rms_eps,
        shards=getattr(cfg, "mixer_shards", 1),
    )


def macro_counts(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(num_macro, mamba_per_macro, tail)."""
    num_macro = cfg.num_layers // cfg.attn_every
    per = cfg.attn_every - 1
    tail = cfg.num_layers - num_macro * cfg.attn_every
    return num_macro, per, tail


# -- shapes / init ---------------------------------------------------------------

def _mamba_layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    shapes = {f"m_{k}": v for k, v in mamba2.mamba2_param_shapes(m2_spec(cfg)).items()}
    shapes["m_ln"] = (cfg.d_model,)
    return shapes


def _shared_block_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    shapes = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    shapes.update({f"attn_{k}": v for k, v in
                   layers.attn_param_shapes(attn_spec(cfg)).items()})
    shapes.update({f"ffn_{k}": v for k, v in
                   layers.swiglu_param_shapes(cfg.d_model, cfg.d_ff).items()})
    return shapes


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    num_macro, per, tail = macro_counts(cfg)
    ml = _mamba_layer_shapes(cfg)
    return {
        "embed": (cfg.vocab_size, cfg.d_model),
        "final_norm": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab_size),
        "macro": {k: (num_macro, per, *v) for k, v in ml.items()},
        "tail": {k: (tail, *v) for k, v in ml.items()},
        "shared": _shared_block_shapes(cfg),
    }


def _init_mamba_layer(cfg: ModelConfig, gen: torch.Generator, keep, stack: str
                      ) -> Params:
    dt = _dtype(cfg)
    p = {f"m_{k}": v for k, v in mamba2.init_mamba2(gen, m2_spec(cfg), dt).items()}
    p["m_ln"] = torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    return layers.keep_leaves(keep, stack, p)


def init_params(cfg: ModelConfig, gen: torch.Generator, keep=None) -> Params:
    """Random parameters on ``gen``'s device: the reference's distributions
    and dtypes (``A_log``, ``D``, ``dt_bias`` f32), not its numbers.
    ``keep(path, leaf)`` replaces each leaf as it is drawn
    (``layers.keep_leaves``)."""
    dt = _dtype(cfg)
    dev = gen.device
    num_macro, per, tail = macro_counts(cfg)
    shared: Params = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                      "ln2": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
    shared.update({f"attn_{k}": v for k, v in
                   layers.init_attn(gen, attn_spec(cfg), dt).items()})
    shared.update({f"ffn_{k}": v for k, v in
                   layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt).items()})
    shared = layers.keep_leaves(keep, "['shared']", shared)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev)
    top = layers.keep_leaves(keep, "", {
        "embed": embed.mul_(0.02).to(dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt),
    })
    return top | {
        "macro": layers.stack_layers((num_macro, per),
                                     lambda: _init_mamba_layer(cfg, gen, keep, "['macro']")),
        "tail": layers.stack_layers((tail,),
                                    lambda: _init_mamba_layer(cfg, gen, keep, "['tail']")),
        "shared": shared,
    }


# -- forward -----------------------------------------------------------------------

def _mamba_layer_fwd(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                     state: Optional[Dict] = None):
    h = layers.rmsnorm(x, lp["m_ln"], cfg.rms_eps)
    y, new_state = mamba2.mamba2_block(_sub(lp, "m_"), m2_spec(cfg), h,
                                       ssd_impl=cfg.ssd_impl, state=state)
    return x + y, new_state


def _shared_block_fwd(cfg: ModelConfig, sp: Params, x: torch.Tensor,
                      positions: torch.Tensor, attn_impl: Optional[str] = None
                      ) -> torch.Tensor:
    h = layers.rmsnorm(x, sp["ln1"], cfg.rms_eps)
    x = x + layers.attn_block(_sub(sp, "attn_"), attn_spec(cfg), h, positions,
                              causal=True, attn_impl=attn_impl or cfg.attn_impl)
    h = layers.rmsnorm(x, sp["ln2"], cfg.rms_eps)
    return x + layers.swiglu(_sub(sp, "ffn_"), h)


def _macro_fwd(cfg: ModelConfig, mamba_layers: list, sp: Params, x: torch.Tensor,
               positions: torch.Tensor, attn_impl: Optional[str]) -> torch.Tensor:
    for lp in mamba_layers:
        x, _ = _mamba_layer_fwd(cfg, gather_params(lp, "['macro']"), x)
    return _shared_block_fwd(cfg, gather_params(sp, "['shared']"), x, positions,
                             attn_impl)


def _tail_fwd(cfg: ModelConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    return _mamba_layer_fwd(cfg, gather_params(lp, "['tail']"), x)[0]


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(x, layers.leaf(params, "final_norm"), cfg.rms_eps)
    return (x @ layers.leaf(params, "lm_head")).float()


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            attn_impl: Optional[str] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in f32."""
    num_macro, per, tail = macro_counts(cfg)
    x = F.embedding(tokens.long(), layers.leaf(params, "embed"))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for mp in layers.unstack_layers(params["macro"], num_macro):
        x = layers.remat(cfg, _macro_fwd, cfg, layers.unstack_layers(mp, per),
                         params["shared"], x, positions, attn_impl)
    for lp in layers.unstack_layers(params["tail"], tail):
        x = layers.remat(cfg, _tail_fwd, cfg, lp, x)
    return _logits(cfg, params, x)


# -- serving -----------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Dict[str, Any]:
    """Recurrent states per mamba layer, (num_macro, per, ...) and (tail,
    ...), and a bf16 KV cache of one layer a shared-block application."""
    num_macro, per, tail = macro_counts(cfg)
    ms = mamba2.mamba2_state_specs(m2_spec(cfg), batch)
    kv = kvcache.init_kv_cache(num_macro, batch, cfg.num_kv_heads, max_len,
                               cfg.head_dim, device=device)
    return {
        "macro_ssm": {k: torch.zeros((num_macro, per, *shape), dtype=dt, device=device)
                      for k, (shape, dt) in ms.items()},
        "tail_ssm": {k: torch.zeros((tail, *shape), dtype=dt, device=device)
                     for k, (shape, dt) in ms.items()},
        "k": kv["k"], "v": kv["v"], "length": kv["length"],
    }


def _stack_states(states: list, lead: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
    """Per-layer state dicts -> stacks of shape ``lead + leaf shape`` (the
    reference's scan outputs)."""
    return {k: torch.stack([st[k] for st in states]).reshape(*lead, *states[0][k].shape)
            for k in states[0]}


def _run_layers(cfg: ModelConfig, params: Params, cache: Dict, x: torch.Tensor,
                positions: torch.Tensor, shared_attention) -> Tuple[torch.Tensor, Dict]:
    """The state-carrying pass of decode and prefill: every mamba layer from
    its cached state, and the shared block whose attention
    ``shared_attention(m, q, k, v)`` writes KV layer m and attends.
    Returns (x, the new macro and tail states)."""
    num_macro, per, tail = macro_counts(cfg)
    s = attn_spec(cfg)
    sp = gather_params(params["shared"], "['shared']")
    macro_states = []
    for m in range(num_macro):
        for j in range(per):
            lp = gather_params({k: v[m, j] for k, v in params["macro"].items()},
                               "['macro']")
            st = {k: v[m, j] for k, v in cache["macro_ssm"].items()}
            x, st = _mamba_layer_fwd(cfg, lp, x, state=st)
            macro_states.append(st)
        h = layers.rmsnorm(x, sp["ln1"], cfg.rms_eps)
        q, k, v = layers.attn_qkv(_sub(sp, "attn_"), s, h, positions)
        o = shared_attention(m, q, k, v)
        x = x + project_out(layers._merge_heads(o), sp["attn_wo"], "attn")
        h = layers.rmsnorm(x, sp["ln2"], cfg.rms_eps)
        x = x + layers.swiglu(_sub(sp, "ffn_"), h)
    new = {"macro_ssm": _stack_states(macro_states, (num_macro, per)),
           "tail_ssm": cache["tail_ssm"]}
    if tail:
        tail_states = []
        for t in range(tail):
            lp = gather_params({k: v[t] for k, v in params["tail"].items()},
                               "['tail']")
            st = {k: v[t] for k, v in cache["tail_ssm"].items()}
            x, st = _mamba_layer_fwd(cfg, lp, x, state=st)
            tail_states.append(st)
        new["tail_ssm"] = _stack_states(tail_states, (tail,))
    return x, new


def decode_step(cfg: ModelConfig, params: Params, cache: Dict,
                tokens: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """One lockstep decode step; tokens (B, 1).  Returns (cache, logits
    (B, 1, V))."""
    B = tokens.shape[0]
    x = layers.leaf(params, "embed")[tokens.long()]
    length = cache["length"]
    positions = length.expand(B)[:, None]

    def shared_attention(m, q, k, v):
        kc, vc = cache["k"][m], cache["v"][m]
        kvcache.update_layer_cache(kc, vc, k, v, length)
        return kvcache.decode_attention(q, kc, vc, length, window=cfg.window)

    x, states = _run_layers(cfg, params, cache, x, positions, shared_attention)
    return {**cache, **states, "length": length + 1}, _logits(cfg, params, x)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Dict) -> Tuple[Dict, torch.Tensor]:
    """Prompts (B, S) through the state-carrying pass: the selected SSD
    variant (chunked: S a multiple of the chunk, or shorter) and causal
    ``ATTENTION_VARIANTS[cfg.attn_impl]``, filling the states and the
    shared block's KV cache.  Returns (cache, last-position logits
    (B, 1, V))."""
    S = tokens.shape[1]
    x = layers.leaf(params, "embed")[tokens.long()]
    positions = torch.arange(S, device=tokens.device)
    attn = layers.ATTENTION_VARIANTS[cfg.attn_impl]
    zero = torch.zeros((), dtype=torch.int32, device=tokens.device)

    def shared_attention(m, q, k, v):
        kvcache.update_layer_cache(cache["k"][m], cache["v"][m], k, v, zero)
        return attn(q, k, v, causal=True, window=cfg.window)

    x, states = _run_layers(cfg, params, cache, x, positions, shared_attention)
    length = torch.full((), S, dtype=torch.int32, device=tokens.device)
    return {**cache, **states, "length": length}, _logits(cfg, params, x[:, -1:])
