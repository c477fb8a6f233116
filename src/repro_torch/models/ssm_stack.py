"""RWKV6 model stack (family: ssm; rwkv6-7b).

The counterpart of ``repro.models.ssm_stack``.  Attention-free: no KV
cache — a layer's state is O(1) in the sequence length.  The steps walk
``params["layers"]`` (stacked on a leading L axis) in a Python loop where
the reference scans; the training forward recomputes each layer in the
backward pass under ``cfg.remat == "full"``.  Decode and prefill carry the
states and return them, with the length, in a new cache dict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.group import gather_params

from . import layers, rwkv6
from .layers import Params
from .transformer import _dtype

STATE_KEYS = ("x_tm", "x_cm", "S")


def r6_spec(cfg: ModelConfig) -> rwkv6.RWKV6Spec:
    """The block's spec; a mesh rank's config (``ShardConfig``) gives its
    share of the heads."""
    return rwkv6.RWKV6Spec(
        d_model=cfg.d_model,
        d_ff=cfg.d_ff,
        head_dim=cfg.rwkv_head_dim,
        chunk=cfg.rwkv_chunk,
        rms_eps=cfg.rms_eps,
        shards=getattr(cfg, "mixer_shards", 1),
    )


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    ls = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    ls.update(rwkv6.rwkv6_param_shapes(r6_spec(cfg)))
    return {
        "embed": (cfg.vocab_size, cfg.d_model),
        "final_norm": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab_size),
        "layers": {k: (cfg.num_layers, *v) for k, v in ls.items()},
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, keep=None) -> Params:
    """Random parameters on ``gen``'s device: the reference's distributions
    and dtypes (``w_base``, ``w_lora_*``, ``u`` f32), not its numbers.
    ``keep(path, leaf)`` replaces each leaf as it is drawn
    (``layers.keep_leaves``)."""
    dt = _dtype(cfg)
    dev = gen.device

    def one():
        p = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=dev),
             "ln2": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
        p.update(rwkv6.init_rwkv6(gen, r6_spec(cfg), dt))
        return layers.keep_leaves(keep, "['layers']", p)

    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev)
    return layers.keep_leaves(keep, "", {
        "embed": embed.mul_(0.02).to(dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt),
    }) | {"layers": layers.stack_layers((cfg.num_layers,), one)}


def _layer_fwd(cfg: ModelConfig, lp: Params, x: torch.Tensor,
               state: Optional[Dict] = None):
    s = r6_spec(cfg)
    h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
    tm_state = None if state is None else {"x_tm": state["x_tm"], "S": state["S"]}
    y, tm_new = rwkv6.rwkv6_time_mix(lp, s, h, wkv_impl=cfg.wkv_impl, state=tm_state)
    x = x + y
    h = layers.rmsnorm(x, lp["ln2"], cfg.rms_eps)
    cm_state = None if state is None else {"x_cm": state["x_cm"]}
    y, cm_new = rwkv6.rwkv6_channel_mix(lp, s, h, state=cm_state)
    x = x + y
    new_state = None if state is None else {**tm_new, **cm_new}
    return x, new_state


def _train_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    return _layer_fwd(cfg, gather_params(lp, "['layers']"), x)[0]


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(x, layers.leaf(params, "final_norm"), cfg.rms_eps)
    return (x @ layers.leaf(params, "lm_head")).float()


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in f32."""
    x = F.embedding(tokens.long(), layers.leaf(params, "embed"))
    for lp in layers.unstack_layers(params["layers"], cfg.num_layers):
        x = layers.remat(cfg, _train_layer, cfg, lp, x)
    return _logits(cfg, params, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Dict[str, Any]:
    """Per-layer states (L, ...) in their declared dtypes and a scalar
    length; ``max_len`` sizes nothing (the state is O(1))."""
    out = {k: torch.zeros((cfg.num_layers, *shape), dtype=dt, device=device)
           for k, (shape, dt) in rwkv6.rwkv6_state_specs(r6_spec(cfg), batch).items()}
    out["length"] = torch.zeros((), dtype=torch.int32, device=device)
    return out


def _run_layers(cfg: ModelConfig, params: Params, cache: Dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every layer from its cached state; returns (x, the new states stacked
    on the L axis)."""
    states = []
    for l in range(cfg.num_layers):
        lp = gather_params({k: v[l] for k, v in params["layers"].items()},
                           "['layers']")
        x, st = _layer_fwd(cfg, lp, x, state={k: cache[k][l] for k in STATE_KEYS})
        states.append(st)
    return x, {k: torch.stack([st[k] for st in states]) for k in STATE_KEYS}


def decode_step(cfg: ModelConfig, params: Params, cache: Dict,
                tokens: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """One lockstep decode step; tokens (B, 1).  Returns (cache, logits
    (B, 1, V))."""
    x, states = _run_layers(cfg, params, cache, layers.leaf(params, "embed")[tokens.long()])
    return {**states, "length": cache["length"] + 1}, _logits(cfg, params, x)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Dict) -> Tuple[Dict, torch.Tensor]:
    """Prompts (B, S) through the state-carrying pass (the chunked WKV form
    under ``wkv_impl="chunked"``: S a multiple of the chunk, or shorter).
    Returns (cache, last-position logits (B, 1, V))."""
    x, states = _run_layers(cfg, params, cache, layers.leaf(params, "embed")[tokens.long()])
    length = torch.full((), tokens.shape[1], dtype=torch.int32,
                        device=tokens.device)
    return {**states, "length": length}, _logits(cfg, params, x[:, -1:])
