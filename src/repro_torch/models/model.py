"""Model facade: family dispatch for the serving and training surfaces of
the port.

The counterpart of ``repro.models.model``: every family the reference
assembles — dense, moe and vlm (the transformer), ssm (:mod:`.ssm_stack`),
hybrid (:mod:`.hybrid`) and encdec (:mod:`.encdec`) — with the lockstep
cache of the wave path, and, for the transformer families only, the
slot-serving steps (contiguous, paged and ``auto`` KV layouts); the other
families raise the reference's ``ValueError`` there.  ``batch`` is a dict
{"tokens", "labels"} (+ "frames" for encdec, the stubbed frontend's
output).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig

from . import encdec, hybrid, ssm_stack, transformer

_FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,   # chameleon: early-fusion = ordinary token ids
    "hybrid": hybrid,
    "ssm": ssm_stack,
    "encdec": encdec,
}
_SLOT_FAMILIES = ("dense", "moe", "vlm")


def family_module(cfg: ModelConfig):
    return _FAMILIES[cfg.family]


def supports_slot_serving(cfg: ModelConfig) -> bool:
    """Slot-recycled continuous batching needs a positional KV cache;
    recurrent/hybrid/encdec families keep lockstep serving."""
    return cfg.family in _SLOT_FAMILIES


def _slot_module(cfg: ModelConfig):
    if not supports_slot_serving(cfg):
        raise ValueError(
            f"continuous batching unsupported for family {cfg.family!r} "
            f"(supported: {_SLOT_FAMILIES})")
    return family_module(cfg)


def param_shapes(cfg: ModelConfig) -> Any:
    return family_module(cfg).param_shapes(cfg)


def count_params_from_shapes(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count; ``active_only`` scales each ``experts_``
    leaf by ``top_k / num_experts`` (the reference's per-token count)."""
    total = 0
    for path, shape in pytree.tree_flatten_with_path(
            param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))[0]:
        n = math.prod(shape)
        if active_only and any("experts_" in str(getattr(k, "key", k)) for k in path):
            n = int(n * cfg.top_k / max(cfg.num_experts, 1))
        total += n
    return total


def init_params(cfg: ModelConfig, gen: torch.Generator,
                keep: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                ) -> Any:
    """Random parameters drawn from ``gen``.  ``keep(path, leaf)``, where
    given, replaces each leaf by what a mesh rank keeps of it, with the
    same numbers: every family applies it to each layer's leaf as soon as
    it is drawn, so the rank never holds the whole parameters."""
    return family_module(cfg).init_params(cfg, gen, keep=keep)


# -- training ------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Any, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """batch {"tokens": (B, S)} (+ "frames" (B, T_src, d) for encdec) ->
    logits (B, S, V) in f32."""
    if cfg.family == "encdec":
        return encdec.forward(cfg, params, batch["frames"], batch["tokens"])
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
    return _slot_module(cfg).init_slot_cache(cfg, slots, max_len, device)


def prefill(cfg: ModelConfig, params: Any, batch: Dict[str, torch.Tensor],
            cache: Dict) -> Tuple[Dict, torch.Tensor]:
    """batch {"tokens": (B, S)} (+ "frames" for encdec): the filled lockstep
    cache and the last position's logits (B, 1, V).

    encdec takes the reference's branch: encode the frames, fill the cross
    K/V, and the last logits of the whole-prompt decoder pass.  As in the
    reference, that leaves the decoder's self-attention cache empty (length
    0): decoding starts from position 0 without the prompt's K/V."""
    if cfg.family == "encdec":
        enc_out = encdec.encode(cfg, params, batch["frames"])
        xk, xv = encdec.precompute_cross_kv(cfg, params, enc_out)
        cache = {**cache, "xk": xk, "xv": xv}
        logits = encdec.decode_train(cfg, params, batch["tokens"], enc_out)
        return cache, logits[:, -1:, :]
    return family_module(cfg).prefill(cfg, params, batch["tokens"], cache)


def prefill_slot_kv(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
                    true_len: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _slot_module(cfg).prefill_slot_kv(cfg, params, tokens, true_len)


def prefill_suffix_kv(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
                      prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                      prefix_len: int, true_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _slot_module(cfg).prefill_suffix_kv(
        cfg, params, tokens, prefix_k, prefix_v, prefix_len, true_len)


def decode_step(cfg: ModelConfig, params: Any, cache: Dict,
                tokens: torch.Tensor, decode_impl: str = "grouped",
                advance: Optional[torch.Tensor] = None
                ) -> Tuple[Dict, torch.Tensor]:
    """One decode step over a contiguous cache (lockstep or per slot).  The
    lockstep families without slot serving take neither ``decode_impl`` nor
    ``advance``."""
    if not supports_slot_serving(cfg):
        if decode_impl != "grouped" or advance is not None:
            raise ValueError(f"family {cfg.family!r} decodes in lockstep: no "
                             f"decode_impl or advance")
        return family_module(cfg).decode_step(cfg, params, cache, tokens)
    return family_module(cfg).decode_step(cfg, params, cache, tokens,
                                          decode_impl=decode_impl,
                                          advance=advance)


def decode_step_mixed(cfg: ModelConfig, params: Any, cache: Dict, pool: Dict,
                      tokens: torch.Tensor, use_paged: torch.Tensor,
                      live: torch.Tensor, decode_impl: str = "grouped",
                      advance: Optional[torch.Tensor] = None
                      ) -> Tuple[Dict, Dict, torch.Tensor]:
    """Decode step of ``kv_layout="auto"``: returns (cache, pool, logits)."""
    return _slot_module(cfg).decode_step_mixed(
        cfg, params, cache, pool, tokens, use_paged, live,
        decode_impl=decode_impl, advance=advance)


def decode_steps_slots(cfg: ModelConfig, params: Any, cache: Dict,
                       tokens: torch.Tensor, live: torch.Tensor,
                       eos_ids: torch.Tensor, budget: torch.Tensor,
                       horizon: int, decode_impl: str = "grouped"
                       ) -> Tuple[Dict, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused decode over the contiguous slot cache: returns (cache,
    tok_block (B, H), valid (B, H), final_tok (B,))."""
    return _slot_module(cfg).decode_steps_slots(
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
    return _slot_module(cfg).decode_steps_mixed(
        cfg, params, cache, pool, tokens, use_paged, live, eos_ids, budget,
        horizon, decode_impl=decode_impl)


def init_page_pool(cfg: ModelConfig, num_pages: int, block_size: int,
                   device: torch.device) -> Dict:
    return _slot_module(cfg).init_page_pool(cfg, num_pages, block_size, device)


def init_paged_cache(cfg: ModelConfig, slots: int, max_len: int,
                     block_size: int, trash: int, device: torch.device) -> Dict:
    return _slot_module(cfg).init_paged_cache(cfg, slots, max_len, block_size,
                                               trash, device)


def prefill_chunk_paged(cfg: ModelConfig, params: Any, pool: Dict,
                        bt_row: torch.Tensor, tokens: torch.Tensor,
                        base: int, chunk_len: int, kernel: str = "gather"
                        ) -> Tuple[Dict, torch.Tensor]:
    """One prompt chunk prefilled directly over the paged KV layout
    (``kernel``: ``"gather"`` or ``"cuda"``)."""
    return _slot_module(cfg).prefill_chunk_paged(
        cfg, params, pool, bt_row, tokens, base, chunk_len, kernel=kernel)


def decode_step_paged(cfg: ModelConfig, params: Any, pool: Dict, cache: Dict,
                      tokens: torch.Tensor, live: torch.Tensor,
                      decode_impl: str = "grouped",
                      advance: Optional[torch.Tensor] = None
                      ) -> Tuple[Dict, Dict, torch.Tensor]:
    return _slot_module(cfg).decode_step_paged(cfg, params, pool, cache,
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
    return _slot_module(cfg).decode_steps_paged(
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
    return _slot_module(cfg).spec_verify_paged(
        cfg, params, pool, cache, tokens, live, eos_ids, budget)


def spec_verify_mixed(cfg: ModelConfig, params: Any, cache: Dict, pool: Dict,
                      tokens: torch.Tensor, use_paged: torch.Tensor,
                      live: torch.Tensor, eos_ids: torch.Tensor,
                      budget: torch.Tensor
                      ) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Speculative verify of ``kv_layout="auto"``: returns (cache, pool,
    tok_block, valid, final_tok)."""
    return _slot_module(cfg).spec_verify_mixed(
        cfg, params, cache, pool, tokens, use_paged, live, eos_ids, budget)
