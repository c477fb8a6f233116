"""Model facade: family dispatch for the serving and training surfaces of
the port.

The subset of ``repro.models.model`` the serving paths (the contiguous,
paged and ``auto`` KV layouts, and the wave path's lockstep cache) and the
training loop need.  Only the dense family is ported; the other families
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig

from . import transformer

_SLOT_FAMILIES = ("dense", "moe", "vlm")
_PORTED = {"dense": transformer}


def supports_slot_serving(cfg: ModelConfig) -> bool:
    """Slot-recycled continuous batching needs a positional KV cache;
    recurrent/hybrid/encdec families keep lockstep serving."""
    return cfg.family in _SLOT_FAMILIES


def family_module(cfg: ModelConfig):
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            f"'Other families'); the port serves {sorted(_PORTED)}")
    return _PORTED[cfg.family]


def param_shapes(cfg: ModelConfig) -> Any:
    return family_module(cfg).param_shapes(cfg)


def count_params_from_shapes(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (dense: every parameter is active)."""
    leaves = pytree.tree_leaves(param_shapes(cfg),
                                is_leaf=lambda x: isinstance(x, tuple))
    return sum(math.prod(shape) for shape in leaves)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Any:
    return family_module(cfg).init_params(cfg, gen)


# -- training ------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Any, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """batch {"tokens": (B, S)} -> logits (B, S, V) in f32."""
    return family_module(cfg).forward(cfg, params, batch["tokens"])


def loss_fn(cfg: ModelConfig, params: Any, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Mean next-token cross-entropy over f32 logits (labels = tokens
    shifted by the caller): mean of ``logsumexp - gold``."""
    logits = forward(cfg, params, batch)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    return torch.mean(logz - gold)


# -- serving ------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Dict:
    return family_module(cfg).init_cache(cfg, batch, max_len, device)


def init_slot_cache(cfg: ModelConfig, slots: int, max_len: int,
                    device: torch.device) -> Dict:
    return family_module(cfg).init_slot_cache(cfg, slots, max_len, device)


def prefill(cfg: ModelConfig, params: Any, batch: Dict[str, torch.Tensor],
            cache: Dict) -> Tuple[Dict, torch.Tensor]:
    """batch {"tokens": (B, S)}: the lockstep cache filled in place, and the
    last position's logits (B, 1, V)."""
    return family_module(cfg).prefill(cfg, params, batch["tokens"], cache)


def prefill_slot_kv(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
                    true_len: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return family_module(cfg).prefill_slot_kv(cfg, params, tokens, true_len)


def prefill_suffix_kv(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
                      prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                      prefix_len: int, true_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return family_module(cfg).prefill_suffix_kv(
        cfg, params, tokens, prefix_k, prefix_v, prefix_len, true_len)


def decode_step(cfg: ModelConfig, params: Any, cache: Dict,
                tokens: torch.Tensor, decode_impl: str = "grouped",
                advance: Optional[torch.Tensor] = None
                ) -> Tuple[Dict, torch.Tensor]:
    """One decode step over a contiguous cache (lockstep or per slot)."""
    return family_module(cfg).decode_step(cfg, params, cache, tokens,
                                          decode_impl=decode_impl,
                                          advance=advance)


def decode_step_mixed(cfg: ModelConfig, params: Any, cache: Dict, pool: Dict,
                      tokens: torch.Tensor, use_paged: torch.Tensor,
                      live: torch.Tensor, decode_impl: str = "grouped",
                      advance: Optional[torch.Tensor] = None
                      ) -> Tuple[Dict, Dict, torch.Tensor]:
    """Decode step of ``kv_layout="auto"``: returns (cache, pool, logits)."""
    return family_module(cfg).decode_step_mixed(
        cfg, params, cache, pool, tokens, use_paged, live,
        decode_impl=decode_impl, advance=advance)


def decode_steps_slots(cfg: ModelConfig, params: Any, cache: Dict,
                       tokens: torch.Tensor, live: torch.Tensor,
                       eos_ids: torch.Tensor, budget: torch.Tensor,
                       horizon: int, decode_impl: str = "grouped"
                       ) -> Tuple[Dict, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused decode over the contiguous slot cache: returns (cache,
    tok_block (B, H), valid (B, H), final_tok (B,))."""
    return family_module(cfg).decode_steps_slots(
        cfg, params, cache, tokens, live, eos_ids, budget, horizon,
        decode_impl=decode_impl)


def decode_steps_mixed(cfg: ModelConfig, params: Any, cache: Dict, pool: Dict,
                       tokens: torch.Tensor, use_paged: torch.Tensor,
                       live: torch.Tensor, eos_ids: torch.Tensor,
                       budget: torch.Tensor, horizon: int,
                       decode_impl: str = "grouped"
                       ) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Fused decode of ``kv_layout="auto"``: returns (cache, pool,
    tok_block, valid, final_tok)."""
    return family_module(cfg).decode_steps_mixed(
        cfg, params, cache, pool, tokens, use_paged, live, eos_ids, budget,
        horizon, decode_impl=decode_impl)


def init_page_pool(cfg: ModelConfig, num_pages: int, block_size: int,
                   device: torch.device) -> Dict:
    return family_module(cfg).init_page_pool(cfg, num_pages, block_size, device)


def init_paged_cache(cfg: ModelConfig, slots: int, max_len: int,
                     block_size: int, trash: int, device: torch.device) -> Dict:
    return family_module(cfg).init_paged_cache(cfg, slots, max_len, block_size,
                                               trash, device)


def prefill_chunk_paged(cfg: ModelConfig, params: Any, pool: Dict,
                        bt_row: torch.Tensor, tokens: torch.Tensor,
                        base: int, chunk_len: int, kernel: str = "gather"
                        ) -> Tuple[Dict, torch.Tensor]:
    """One prompt chunk prefilled directly over the paged KV layout
    (``kernel``: ``"gather"`` or ``"cuda"``)."""
    return family_module(cfg).prefill_chunk_paged(
        cfg, params, pool, bt_row, tokens, base, chunk_len, kernel=kernel)


def decode_step_paged(cfg: ModelConfig, params: Any, pool: Dict, cache: Dict,
                      tokens: torch.Tensor, live: torch.Tensor,
                      decode_impl: str = "grouped",
                      advance: Optional[torch.Tensor] = None
                      ) -> Tuple[Dict, Dict, torch.Tensor]:
    return family_module(cfg).decode_step_paged(cfg, params, pool, cache,
                                                tokens, live,
                                                decode_impl=decode_impl,
                                                advance=advance)


def decode_steps_paged(cfg: ModelConfig, params: Any, pool: Dict, cache: Dict,
                       tokens: torch.Tensor, live: torch.Tensor,
                       eos_ids: torch.Tensor, budget: torch.Tensor,
                       horizon: int, decode_impl: str = "grouped"
                       ) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Fused ``horizon``-step greedy decode over the paged layout: returns
    (pool, cache, tok_block (B, H), valid (B, H), final_tok (B,))."""
    return family_module(cfg).decode_steps_paged(
        cfg, params, pool, cache, tokens, live, eos_ids, budget, horizon,
        decode_impl=decode_impl)


def spec_verify_paged(cfg: ModelConfig, params: Any, pool: Dict, cache: Dict,
                      tokens: torch.Tensor, live: torch.Tensor,
                      eos_ids: torch.Tensor, budget: torch.Tensor
                      ) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """One-pass speculative verify of an S-token span a slot over the paged
    layout: returns (pool, cache, tok_block (B, S), valid (B, S), final_tok
    (B,)); ``cache["length"]`` moves in place."""
    return family_module(cfg).spec_verify_paged(
        cfg, params, pool, cache, tokens, live, eos_ids, budget)


def spec_verify_mixed(cfg: ModelConfig, params: Any, cache: Dict, pool: Dict,
                      tokens: torch.Tensor, use_paged: torch.Tensor,
                      live: torch.Tensor, eos_ids: torch.Tensor,
                      budget: torch.Tensor
                      ) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Speculative verify of ``kv_layout="auto"``: returns (cache, pool,
    tok_block, valid, final_tok)."""
    return family_module(cfg).spec_verify_mixed(
        cfg, params, cache, pool, tokens, use_paged, live, eos_ids, budget)
