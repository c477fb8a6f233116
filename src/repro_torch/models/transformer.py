"""Decoder-only transformer (families: dense, moe, vlm): parameters, the
whole-sequence training forward and the serving steps of the three KV
layouts (contiguous slot cache, paged pool, and ``auto``'s both at once).

The counterpart of ``repro.models.transformer``.  Covers qwen2-7b (GQA +
QKV bias), qwen3-8b (qk_norm), qwen2.5-32b, h2o-danube-3-4b (SWA),
chameleon-34b (vlm: qk_norm, early-fusion token ids) and qwen2-moe-a2.7b
and moonshot-v1-16b-a3b (shared + routed top-k MoE, :mod:`.moe`).  Every
FFN site goes through :func:`_ffn`, which routes the rows it is given
together: a decode step routes all slots, live or not, a verify call B*S
rows, a prefill chunk or a whole prompt its padded length, as the
reference does, because an MoE layer's capacity depends on that count.

The parameter dict has the reference's layout — per-layer weights stacked
on a leading L axis under ``params["layers"]`` — and the steps walk the
layers in a Python loop where the reference scans (``params["layers"][name]
[l]`` is a view, so the loop copies no weights).  The training forward
splits each stack once with :func:`layers.unstack_layers` instead (see
there why).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.group import (enter_split, gather_params, keep_scope,
                                           project_out)

from . import kvcache, layers, moe
from .layers import AttnSpec, Params


def attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        window=cfg.window,
        rope_theta=cfg.rope_theta,
        rms_eps=cfg.rms_eps,
    )


def moe_spec(cfg: ModelConfig) -> moe.MoESpec:
    return moe.MoESpec(
        d_model=cfg.d_model,
        num_experts=cfg.num_experts,
        top_k=cfg.top_k,
        moe_d_ff=cfg.moe_d_ff,
        num_shared_experts=cfg.num_shared_experts,
        capacity_factor=cfg.capacity_factor,
        pad_to=cfg.moe_pad_experts,
    )


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# -- parameter shapes -------------------------------------------------------------

def layer_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    s = attn_spec(cfg)
    shapes: Dict[str, Tuple] = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    shapes.update({f"attn_{k}": v for k, v in layers.attn_param_shapes(s).items()})
    if cfg.family == "moe":
        shapes.update({f"moe_{k}": v for k, v in
                       moe.moe_param_shapes(moe_spec(cfg)).items()})
    else:
        shapes.update({f"ffn_{k}": v for k, v in
                       layers.swiglu_param_shapes(cfg.d_model, cfg.d_ff).items()})
    return shapes


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    shapes: Dict[str, Any] = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "final_norm": (cfg.d_model,),
        "layers": {k: (cfg.num_layers, *v) for k, v in layer_param_shapes(cfg).items()},
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return shapes


# -- init -------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator,
                keep: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                ) -> Params:
    """Random parameters on ``gen``'s device, drawn from ``gen``: the same
    distributions and dtypes as the reference's ``init_params`` (an MoE
    router stays f32), not the same numbers — parity tests convert the
    reference's parameters instead, :mod:`repro_torch.models.convert`.
    ``keep(path, leaf)`` replaces each layer's leaf as it is drawn (path
    ``['layers']['name']``), before the next layer is drawn, and each other
    leaf once it is drawn (``['embed']``)."""
    dt = _dtype(cfg)
    dev = gen.device
    s = attn_spec(cfg)

    def one() -> Params:
        p: Params = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                     "ln2": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
        p.update({f"attn_{k}": v for k, v in layers.init_attn(gen, s, dt).items()})
        if cfg.family == "moe":
            p.update({f"moe_{k}": v for k, v in
                      moe.init_moe(gen, moe_spec(cfg), dt).items()})
        else:
            p.update({f"ffn_{k}": v for k, v in
                      layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt).items()})
        if keep is None:
            return p
        return {k: keep(f"['layers'][{k!r}]", v) for k, v in p.items()}

    stacked = layers.stack_layers((cfg.num_layers,), one)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev)
    params: Params = {
        "embed": embed.mul_(0.02).to(dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "layers": stacked,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    if keep is not None:
        params = {k: v if k == "layers" else keep(f"[{k!r}]", v)
                  for k, v in params.items()}
    return params


# -- training forward ----------------------------------------------------------------

def layer_fwd(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    s = attn_spec(cfg)
    p = gather_params(p, "['layers']")
    h = layers.rmsnorm(x, p["ln1"], cfg.rms_eps)
    x = x + layers.attn_block(_sub(p, "attn_"), s, h, positions, causal=True,
                              attn_impl=cfg.attn_impl)
    h = layers.rmsnorm(x, p["ln2"], cfg.rms_eps)
    return x + _ffn(cfg, p, h)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in f32.  ``cfg.remat == "full"``
    recomputes each layer in the backward pass (non-reentrant
    ``torch.utils.checkpoint``), keeping only the layer inputs — the
    counterpart of the reference's ``jax.checkpoint`` around the scan
    body."""
    B, S = tokens.shape
    x = F.embedding(tokens.long(), layers.leaf(params, "embed"))
    positions = torch.arange(S, device=tokens.device)
    for lp in layers.unstack_layers(params["layers"], cfg.num_layers):
        if cfg.remat == "full":
            x = checkpoint(keep_scope(layer_fwd), cfg, lp, x, positions,
                           use_reentrant=False)
        else:
            x = layer_fwd(cfg, lp, x, positions)
    return _logits(cfg, params, x)


# -- serving ------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    """SWA archs keep a ring buffer of window size in the lockstep cache."""
    if cfg.window is not None:
        return min(max_len, cfg.window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> kvcache.Cache:
    """Lockstep cache of the wave path (scalar length; a ring for SWA)."""
    return kvcache.init_kv_cache(cfg.num_layers, batch, cfg.num_kv_heads,
                                 _cache_len(cfg, max_len), cfg.head_dim,
                                 device=device)


def init_slot_cache(cfg: ModelConfig, slots: int, max_len: int,
                    device: torch.device) -> kvcache.Cache:
    """Per-slot contiguous cache for continuous batching: ``length`` is
    (slots,), always the full ``max_len`` (slot insertion needs absolute
    positions, so no ring)."""
    return kvcache.init_kv_cache(cfg.num_layers, slots, cfg.num_kv_heads,
                                 max_len, cfg.head_dim, per_slot=True,
                                 device=device)


def init_page_pool(cfg: ModelConfig, num_pages: int, block_size: int,
                   device: torch.device) -> kvcache.Cache:
    """Unified paged KV pool (+1 trash row) in the COMPUTE dtype."""
    return kvcache.init_page_pool(
        num_pages, cfg.num_layers, cfg.num_kv_heads, block_size,
        cfg.head_dim, dtype=_dtype(cfg), device=device)


def init_paged_cache(cfg: ModelConfig, slots: int, max_len: int,
                     block_size: int, trash: int, device: torch.device) -> Dict:
    """Block table (trash-initialized page ids) plus per-slot lengths.
    ``max_len % block_size == 0`` keeps the gathered width at max_len."""
    if max_len % block_size:
        raise ValueError(f"max_len={max_len} must be a multiple of "
                         f"block_size={block_size}")
    return {
        "bt": torch.full((slots, max_len // block_size), trash,
                         dtype=torch.int32, device=device),
        "length": torch.zeros((slots,), dtype=torch.int32, device=device),
    }


def _layer(params: Params, l: int) -> Params:
    return {k: v[l] for k, v in params["layers"].items()}


def _gathered_layer(params: Params, l: int) -> Params:
    """Layer ``l``'s leaves, under fsdp gathered over the data group (the
    lockstep prefill and decode, which a dry run drives under fsdp)."""
    return gather_params(_layer(params, l), "['layers']")


def _sub(p: Params, prefix: str) -> Params:
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


def _ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    """The FFN half of a layer on h (B, S, d): the MoE block for the moe
    family (its B*S rows routed together), SwiGLU otherwise.  On a rank of
    a head-sharded engine the hidden dim (or the experts) is the rank's
    slice, and the down-projection's partial sum is completed over the
    ranks (the MoE block does so before its cast)."""
    if cfg.family == "moe":
        return moe.moe_block(_sub(lp, "moe_"), moe_spec(cfg), h,
                             groups=cfg.moe_groups)
    p = _sub(lp, "ffn_")
    h = enter_split(h, "ffn")
    return project_out(F.silu(h @ p["w_gate"]) * (h @ p["w_up"]), p["w_down"],
                       "ffn")


def _attn_out(lp: Params, o: torch.Tensor) -> torch.Tensor:
    """The attention output projection of o (B, H, S, D); on a rank of a
    head-sharded engine, over the rank's heads, summed over the ranks."""
    return project_out(layers._merge_heads(o), lp["attn_wo"], "attn")


def _layer_kv_fwd(cfg: ModelConfig, s: AttnSpec, lp: Params, x: torch.Tensor,
                  positions: torch.Tensor, attn_call
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prompt-pass layer; returns (x_out, k, v).  ``attn_call(q, k, v)``
    is the chunk attention (gather or kernel backend)."""
    h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
    q, k, v = layers.attn_qkv(_sub(lp, "attn_"), s, h, positions)
    o = attn_call(q, k, v)
    x = x + _attn_out(lp, o)
    h = layers.rmsnorm(x, lp["ln2"], cfg.rms_eps)
    return x + _ffn(cfg, lp, h), k, v


def _prefix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """GQA attention of chunk queries against gathered+chunk K/V.

    q: (B, Hq, S, D); k/v: (B, Hkv, T, D); mask: (1, S, T) validity.
    Grouped layout and f32 accumulators, probabilities cast to v's dtype
    before the value product (as :func:`kvcache.decode_attention`)."""
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    group = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, group, S, D).float()
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * scale
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Hq, S, D).to(q.dtype)


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(x, layers.leaf(params, "final_norm"), cfg.rms_eps)
    head = (layers.leaf(params, "embed").T if cfg.tie_embeddings
            else layers.leaf(params, "lm_head"))
    return (x @ head).float()


def _prompt_attention(cfg: ModelConfig, s: AttnSpec, attn_impl: Optional[str]):
    """The causal prompt attention ``ATTENTION_VARIANTS[attn_impl or
    cfg.attn_impl]`` (``flash_cuda`` launches the flash kernel)."""
    attn = layers.ATTENTION_VARIANTS[attn_impl or cfg.attn_impl]
    return lambda q, k, v: attn(q, k, v, causal=True, window=s.window)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Dict, attn_impl: Optional[str] = None
            ) -> Tuple[Dict, torch.Tensor]:
    """Run the prompts (B, S), write their K/V into the lockstep ``cache``
    in place (a ring keeps the trailing window) and set its length to S.
    Returns (cache, last-position logits (B, 1, V))."""
    B, S = tokens.shape
    dev = tokens.device
    x = layers.leaf(params, "embed")[tokens.long()]
    positions = torch.arange(S, device=dev)
    s = attn_spec(cfg)
    attn_call = _prompt_attention(cfg, s, attn_impl)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for l in range(cfg.num_layers):
        x, k, v = _layer_kv_fwd(cfg, s, _gathered_layer(params, l), x, positions,
                                attn_call)
        kc, vc = cache["k"][l], cache["v"][l]
        T_eff = kc.shape[2]
        if T_eff < S:       # ring cache: keep the trailing window
            k, v = k[:, :, -T_eff:], v[:, :, -T_eff:]
        kvcache.update_layer_cache(kc, vc, k, v, zero)
    cache["length"].fill_(S)
    return cache, _logits(cfg, params, x[:, -1:])


def prefill_slot_kv(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                    true_len: int, attn_impl: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill ONE prompt for slot insertion.  tokens: (1, S_pad) right-
    padded; ``true_len`` real tokens.  Returns the stacked K/V (L, 1, Hkv,
    S_pad, D) for :func:`kvcache.insert_slot_kv` and the (1, V) logits at
    position ``true_len - 1`` (causality keeps the padding out of every
    real position)."""
    S = tokens.shape[1]
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=tokens.device)
    s = attn_spec(cfg)
    attn_call = _prompt_attention(cfg, s, attn_impl)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        x, k, v = _layer_kv_fwd(cfg, s, _layer(params, l), x, positions,
                                attn_call)
        ks.append(k)
        vs.append(v)
    logits = _logits(cfg, params, x[:, true_len - 1:true_len])[:, 0, :]
    return torch.stack(ks), torch.stack(vs), logits


def prefill_suffix_kv(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                      prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                      prefix_len: int, true_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill ONLY a prompt's suffix against cached prefix K/V.

    prefix_k/v: (L, 1, Hkv, P_pad, D) gathered pages, valid below
    ``prefix_len``; tokens: (1, S_pad) right-padded suffix at absolute
    positions ``prefix_len + i``.  Suffix attention is causal (and
    sliding-window when the arch has one) over prefix and suffix keys,
    through :func:`_prefix_attention`.  Returns the suffix's stacked K/V
    (L, 1, Hkv, S_pad, D), to insert at ``prefix_len``, and the (1, V)
    logits at suffix position ``true_len - 1``."""
    S = tokens.shape[1]
    P_pad = prefix_k.shape[3]
    dev = tokens.device
    x = params["embed"][tokens.long()]
    positions = prefix_len + torch.arange(S, device=dev)
    s = attn_spec(cfg)
    # prefix columns [0, P_pad) at their own positions (valid below
    # prefix_len), suffix columns at prefix_len + local index
    cols = torch.arange(P_pad + S, device=dev)
    col_abs = torch.where(cols < P_pad, cols, prefix_len + cols - P_pad)
    col_valid = (cols >= P_pad) | (cols < prefix_len)
    row_abs = prefix_len + torch.arange(S, device=dev)
    mask = col_valid[None, :] & (col_abs[None, :] <= row_abs[:, None])
    if s.window is not None:
        mask &= col_abs[None, :] > row_abs[:, None] - s.window
    mask = mask[None]                        # (1, S, P_pad + S)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        def attn_call(q, k, v, pk=prefix_k[l], pv=prefix_v[l]):
            k_full = torch.cat([pk.to(k.dtype), k], dim=2)
            v_full = torch.cat([pv.to(v.dtype), v], dim=2)
            return _prefix_attention(q, k_full, v_full, mask)

        x, k, v = _layer_kv_fwd(cfg, s, _layer(params, l), x, positions,
                                attn_call)
        ks.append(k)
        vs.append(v)
    logits = _logits(cfg, params, x[:, true_len - 1:true_len])[:, 0, :]
    return torch.stack(ks), torch.stack(vs), logits


def prefill_chunk_paged(cfg: ModelConfig, params: Params, pool: Dict,
                        bt_row: torch.Tensor, tokens: torch.Tensor,
                        base: int, chunk_len: int, kernel: str = "gather"
                        ) -> Tuple[Dict, torch.Tensor]:
    """Prefill ONE chunk of a prompt directly over the paged KV layout.

    pool: {"k","v"} (L, N, Hkv, bs, D); bt_row: (nb,) int32, the slot's
    block-table row (pages covering ``base + chunk_len`` positions
    allocated, trash past them); tokens: (1, C_pad) right-padded chunk;
    base: absolute position of its first token (positions ``[0, base)``
    already in the pages); chunk_len: real tokens in the chunk.

    ``kernel`` picks the chunk-attention backend (the serve engine's
    ``prefill_kernel`` axis): ``"gather"`` linearizes the row's pages and
    attends over them concatenated with the chunk's own K/V, then writes
    the chunk's K/V; ``"cuda"`` writes first and then scores prefix and
    chunk in place through the multi-query kernel.

    Returns (pool, logits): the pool, updated in place, and the (1, V)
    logits at chunk position ``chunk_len - 1``.
    """
    B, C = tokens.shape
    nb = bt_row.shape[0]
    bs = pool["k"].shape[3]
    T = nb * bs
    dev = tokens.device
    x = params["embed"][tokens.long()]
    positions = base + torch.arange(C, device=dev)
    s = attn_spec(cfg)
    if kernel == "cuda":
        base_t = torch.tensor([base], dtype=torch.int32, device=dev)
        bt2 = bt_row[None].contiguous()
    elif kernel == "gather":
        # columns [0, T) are the linearized pages (absolute position =
        # column, valid below ``base``), columns [T, T+C) the chunk's keys
        cols = torch.arange(T + C, device=dev)
        col_abs = torch.where(cols < T, cols, base + cols - T)
        col_valid = (cols >= T) | (cols < base)
        row_abs = base + torch.arange(C, device=dev)
        mask = col_valid[None, :] & (col_abs[None, :] <= row_abs[:, None])
        if s.window is not None:
            mask &= col_abs[None, :] > row_abs[:, None] - s.window
        mask = mask[None]                 # (1, C, T + C)
    else:
        raise ValueError(f"unknown prefill kernel {kernel!r} (gather, cuda)")

    for l in range(cfg.num_layers):
        pk, pv = pool["k"][l], pool["v"][l]       # (N, Hkv, bs, D) views

        if kernel == "cuda":
            def attn_call(q, k, v, pk=pk, pv=pv):
                # write-then-attend: the kernel reads the chunk's own keys
                # from its pages, so they must land there first
                kvcache.write_chunk_paged_layer(pk, pv, k, v, bt_row, base,
                                                chunk_len)
                return kvcache.paged_prefill_attention_kernel(
                    q, pk, pv, bt2, base_t, chunk_len, window=s.window)

            x, _, _ = _layer_kv_fwd(cfg, s, _layer(params, l), x, positions,
                                    attn_call)
            continue

        def attn_call(q, k, v, pk=pk, pv=pv):
            kg, vg = kvcache.paged_gather_layer(pk, pv, bt_row[None])
            k_full = torch.cat([kg.to(k.dtype), k], dim=2)
            v_full = torch.cat([vg.to(v.dtype), v], dim=2)
            return _prefix_attention(q, k_full, v_full, mask)

        x, k, v = _layer_kv_fwd(cfg, s, _layer(params, l), x, positions,
                                attn_call)
        kvcache.write_chunk_paged_layer(pk, pv, k, v, bt_row, base, chunk_len)

    logits = _logits(cfg, params, x[:, chunk_len - 1:chunk_len])[:, 0, :]
    return pool, logits


def _post_attn(cfg: ModelConfig, lp: Params, x: torch.Tensor, o: torch.Tensor
               ) -> torch.Tensor:
    """Output projection + FFN (or MoE) half of a decode or verify layer."""
    x = x + _attn_out(lp, o)
    h = layers.rmsnorm(x, lp["ln2"], cfg.rms_eps)
    return x + _ffn(cfg, lp, h)


def decode_step(cfg: ModelConfig, params: Params, cache: Dict,
                tokens: torch.Tensor, decode_impl: Optional[str] = None,
                advance: Optional[torch.Tensor] = None
                ) -> Tuple[Dict, torch.Tensor]:
    """One decode step over a contiguous cache; tokens (B, 1).

    A scalar ``length`` is the lockstep batch of the wave path (ring
    caches for SWA); a per-slot ``(B,)`` length is continuous batching:
    every row writes and attends at its own position, and a free slot
    decodes garbage into its own rows that the host discards.  K/V and
    lengths are written in place; lengths move by ``advance`` (by one
    when None) — a slot frozen mid-horizon re-writes its own frozen
    position.  Returns (cache, logits (B, 1, V))."""
    B = tokens.shape[0]
    x = layers.leaf(params, "embed")[tokens.long()]
    length = cache["length"]
    per_slot = length.ndim == 1
    positions = length[:, None] if per_slot else length.expand(B)[:, None]
    s = attn_spec(cfg)
    attn_fn = kvcache.DECODE_ATTN_VARIANTS[decode_impl or "grouped"]
    for l in range(cfg.num_layers):
        lp = _gathered_layer(params, l)
        kc, vc = cache["k"][l], cache["v"][l]
        ring = (not per_slot and cfg.window is not None
                and kc.shape[2] <= cfg.window)
        rw = kc.shape[2] if ring else None
        h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = layers.attn_qkv(_sub(lp, "attn_"), s, h, positions)
        kvcache.update_layer_cache(kc, vc, k, v, length, ring_window=rw)
        o = attn_fn(q, kc, vc, length, window=cfg.window, ring_window=rw)
        x = _post_attn(cfg, lp, x, o)
    logits = _logits(cfg, params, x)
    length.add_(1 if advance is None else advance)
    return cache, logits


def decode_step_mixed(cfg: ModelConfig, params: Params, cache: Dict,
                      pool: Dict, tokens: torch.Tensor, use_paged: torch.Tensor,
                      live: torch.Tensor, decode_impl: Optional[str] = None,
                      advance: Optional[torch.Tensor] = None
                      ) -> Tuple[Dict, Dict, torch.Tensor]:
    """Decode step of ``kv_layout="auto"``: each slot is in EITHER layout.

    cache: the contiguous slot cache plus the block table "bt"; use_paged:
    (B,) int mask of the slots that decode through the pool.  QKV and FFN
    run once; both attention reads are computed and selected per slot
    (each read of a slot in the other layout is garbage the select
    drops).  Writes go to both: the contiguous write stays in the slot's
    own rows, the paged append goes to the trash page for every slot not
    live and paged.  ``cuda`` reads the pages through the decode kernel,
    and the contiguous read is its grouped rung.  Returns (cache, pool,
    logits)."""
    x = params["embed"][tokens.long()]
    length = cache["length"]
    bt = cache["bt"]
    positions = length[:, None]
    trash = pool["k"].shape[1] - 1
    paged_live = live * use_paged
    s = attn_spec(cfg)
    impl = decode_impl or "grouped"
    use_kernel = impl in kvcache.PAGED_KERNEL_IMPLS
    attn_fn = kvcache.DECODE_ATTN_VARIANTS[impl]
    sel = use_paged[:, None, None, None] > 0
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        kc, vc = cache["k"][l], cache["v"][l]
        pk, pv = pool["k"][l], pool["v"][l]
        h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = layers.attn_qkv(_sub(lp, "attn_"), s, h, positions)
        kvcache.update_layer_cache(kc, vc, k, v, length)
        kvcache.append_token_paged(pk, pv, k, v, bt, length, paged_live, trash)
        if use_kernel:
            o_p = kvcache.paged_decode_attention_kernel(
                q, pk, pv, bt, length, window=cfg.window, read_dtype=kc.dtype)
        else:
            kg, vg = kvcache.paged_gather_layer(pk, pv, bt, out_dtype=kc.dtype)
            o_p = attn_fn(q, kg, vg, length, window=cfg.window)
        o_c = attn_fn(q, kc, vc, length, window=cfg.window)
        x = _post_attn(cfg, lp, x, torch.where(sel, o_p, o_c))
    logits = _logits(cfg, params, x)
    length.add_(1 if advance is None else advance)
    return cache, pool, logits


def decode_step_paged(cfg: ModelConfig, params: Params, pool: Dict,
                      cache: Dict, tokens: torch.Tensor, live: torch.Tensor,
                      decode_impl: Optional[str] = None,
                      advance: Optional[torch.Tensor] = None
                      ) -> Tuple[Dict, Dict, torch.Tensor]:
    """One decode step over the PAGED KV layout.

    pool: {"k","v"} (L, N, Hkv, bs, D) (last row = trash), updated in
    place; cache: {"bt": (B, nb) int32, "length": (B,) int32}; tokens:
    (B, 1); live: (B,) int mask (0 = free or prefilling slot — its write
    goes to the trash page).

    Per layer: append the new token's K/V into each live slot's tail page,
    then attend through the block table — by gathering the pages at the
    slot-cache dtype (``grouped``/``flat``), or in place through the decode
    kernel (``cuda``, reading through the same dtype).  Every slot's
    length then moves by ``advance[b]`` (by one when ``advance`` is None),
    written in place into ``cache["length"]``: a captured graph replays
    over that buffer.  Returns (pool, cache, logits (B, 1, V))."""
    x = params["embed"][tokens.long()]
    length = cache["length"]
    bt = cache["bt"]
    positions = length[:, None]
    trash = pool["k"].shape[1] - 1
    s = attn_spec(cfg)
    impl = decode_impl or "grouped"
    use_kernel = impl in kvcache.PAGED_KERNEL_IMPLS
    attn_fn = None if use_kernel else kvcache.DECODE_ATTN_VARIANTS[impl]

    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        pk, pv = pool["k"][l], pool["v"][l]
        h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = layers.attn_qkv(_sub(lp, "attn_"), s, h, positions)
        kvcache.append_token_paged(pk, pv, k, v, bt, length, live, trash)
        if use_kernel:
            o = kvcache.paged_decode_attention_kernel(
                q, pk, pv, bt, length, window=cfg.window)
        else:
            kg, vg = kvcache.paged_gather_layer(
                pk, pv, bt, out_dtype=kvcache.SLOT_CACHE_DTYPE)
            o = attn_fn(q, kg, vg, length, window=cfg.window)
        x = _post_attn(cfg, lp, x, o)

    logits = _logits(cfg, params, x)
    length.add_(1 if advance is None else advance)
    return pool, cache, logits


# -- fused multi-token decode horizons ----------------------------------------
#
# Up to H decode steps back to back on the device: the greedy argmax of
# step j feeds step j+1's embedding without a host round trip, and a stop
# mask (per-slot EOS id, per-slot token budget) freezes a finished slot —
# its page appends go to the trash page, its contiguous writes re-write its
# own frozen position, and its length stops — so nothing it does after
# its stop is observable.  Each step is the SAME single step of the layout
# above with ``advance`` = the not-yet-stopped mask, which makes a horizon
# token-exact with H single steps.  The reference scans this loop inside
# one jit; here it is a Python loop, which the serve engine captures once
# per (layout, decode-attention variant, H) in a CUDA graph and replays
# (:mod:`repro_torch.runtime.decode_graphs`).

def _horizon_loop(step_fn, tokens: torch.Tensor, live: torch.Tensor,
                  eos_ids: torch.Tensor, budget: torch.Tensor, horizon: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stop handling of a fused horizon (``repro``'s ``_horizon_scan``).

    step_fn(tok (B, 1), step_live (B,)) -> logits (B, 1, V) runs one
    single step with ``advance=step_live``.  live: (B,) 0/1 decoding mask;
    eos_ids: (B,) per-slot stop token (-1 = none); budget: (B,) tokens
    each slot may still emit (>= 1 for live slots).  None of the inputs is
    written.

    Returns (tok_block (B, H) int32, valid (B, H) int32, final_tok (B,)
    int32): ``tok_block[i, j]`` is real iff ``valid[i, j]`` — a slot
    stopped at step j has zeros in ``valid`` from j+1 on, so EOS
    mid-horizon emits no trailing tokens (``tok_block`` holds the discarded
    argmax of a frozen or non-live slot there, as the reference's does).  ``final_tok`` is each slot's last valid token (the
    input of its next step), left on the device."""
    live = live.to(torch.int32)
    eos_ids = eos_ids.to(torch.int32)
    tok = tokens[:, 0].to(torch.int32)
    stopped = torch.zeros_like(live)
    rem = budget.to(torch.int32)
    toks, emits = [], []
    for _ in range(horizon):
        step_live = live * (1 - stopped)
        logits = step_fn(tok[:, None], step_live)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        rem = rem - step_live
        stop_now = (step_live > 0) & ((nxt == eos_ids) | (rem <= 0))
        stopped = torch.where(stop_now, 1, stopped)
        tok = torch.where(step_live > 0, nxt, tok)
        toks.append(nxt)
        emits.append(step_live)
    return torch.stack(toks, dim=1), torch.stack(emits, dim=1), tok


def decode_steps_slots(cfg: ModelConfig, params: Params, cache: Dict,
                       tokens: torch.Tensor, live: torch.Tensor,
                       eos_ids: torch.Tensor, budget: torch.Tensor,
                       horizon: int, decode_impl: Optional[str] = None
                       ) -> Tuple[Dict, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused H-step decode over the contiguous slot cache (updated in
    place).  Returns (cache, tok_block (B, H), valid (B, H), final_tok
    (B,)) — see :func:`_horizon_loop` for the stop contract."""
    def step_fn(tok, step_live):
        return decode_step(cfg, params, cache, tok, decode_impl=decode_impl,
                           advance=step_live)[1]

    toks, valid, tok = _horizon_loop(step_fn, tokens, live, eos_ids, budget,
                                     horizon)
    return cache, toks, valid, tok


def decode_steps_mixed(cfg: ModelConfig, params: Params, cache: Dict,
                       pool: Dict, tokens: torch.Tensor, use_paged: torch.Tensor,
                       live: torch.Tensor, eos_ids: torch.Tensor,
                       budget: torch.Tensor, horizon: int,
                       decode_impl: Optional[str] = None
                       ) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Fused H-step decode of ``kv_layout="auto"`` (both reads selected per
    slot, as :func:`decode_step_mixed`); cache and pool updated in place.
    Returns (cache, pool, tok_block, valid, final_tok)."""
    def step_fn(tok, step_live):
        return decode_step_mixed(cfg, params, cache, pool, tok, use_paged,
                                 step_live, decode_impl=decode_impl,
                                 advance=step_live)[2]

    toks, valid, tok = _horizon_loop(step_fn, tokens, live, eos_ids, budget,
                                     horizon)
    return cache, pool, toks, valid, tok


def decode_steps_paged(cfg: ModelConfig, params: Params, pool: Dict,
                       cache: Dict, tokens: torch.Tensor, live: torch.Tensor,
                       eos_ids: torch.Tensor, budget: torch.Tensor,
                       horizon: int, decode_impl: Optional[str] = None
                       ) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Fused H-step decode over the paged KV layout.

    The caller must have installed, before the call, every page the
    horizon can touch (blocks covering positions ``[length, length + H)``
    of each live slot): mid-horizon there is no host to allocate one.  A
    slot frozen by the stop mask appends to the trash page
    (``step_live`` doubles as the append's live mask), so pages reserved
    past its stop stay untouched and can be returned.  Pool and
    ``cache["length"]`` are updated in place.  Returns (pool, cache,
    tok_block (B, H), valid (B, H), final_tok (B,)) — see
    :func:`_horizon_loop` for the stop contract."""
    def step_fn(tok, step_live):
        return decode_step_paged(cfg, params, pool, cache, tok, step_live,
                                 decode_impl=decode_impl, advance=step_live)[2]

    toks, valid, tok = _horizon_loop(step_fn, tokens, live, eos_ids, budget,
                                     horizon)
    return pool, cache, toks, valid, tok


# -- speculative decoding: one-pass draft verification -------------------------
#
# The host drafts up to S-1 candidate tokens a live slot (an n-gram table,
# runtime/spec_decode.py) and ONE pass of the target model scores all S
# positions: candidate j of slot i is embedded at position length[i] + j,
# its K/V written through the slot's block table first, and row j attends
# to col <= length + j, so row j's logits are the ones the sequential
# decode step would give after committing candidates 1..j.  A candidate is
# committed iff it equals the target's own argmax after the prefix before
# it, and the first mismatch gives the target's token as a free correction:
# the committed stream is the greedy stream, whatever the drafts.  The
# rejected tail's K/V stays past the advanced length, masked, and the
# engine returns the pages that held it.  Positions and masks are built
# from ``cache["length"]`` on the device and no Python value depends on
# it, so the serve engine captures a verify call in a CUDA graph, and the
# length moves in place.

def _spec_accept(tokens: torch.Tensor, g: torch.Tensor, live: torch.Tensor,
                 eos_ids: torch.Tensor, budget: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The longest accepted prefix as a commit mask (``repro``'s
    ``_spec_accept``).

    tokens: (B, S), column 0 each slot's last committed token, columns 1..
    the drafts; g: (B, S) the target's argmax at every position (``g[:, j]``
    follows ``tokens[:, j]``).  Draft ``j+1`` is accepted iff it equals
    ``g[:, j]`` and every earlier draft was accepted; committed position j
    emits ``g[:, j]``.  The stop contract of :func:`_horizon_loop` holds on
    top: the token that hits a slot's EOS id or ends its budget is emitted
    and nothing after it, and a slot that is not live emits nothing.

    Returns (valid (B, S) int32, a prefix of each row; n_emit (B,); final
    (B,): each slot's last valid token, its input token when none)."""
    B, S = tokens.shape
    dev = tokens.device
    live = live.to(torch.int32)
    eos_ids = eos_ids.to(torch.int32)
    budget = budget.to(torch.int32)
    idx = torch.arange(S, device=dev)[None, :]
    if S > 1:
        match = (tokens[:, 1:] == g[:, :-1]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)             # (B,)
    else:
        n_acc = torch.zeros((B,), dtype=torch.int64, device=dev)
    commit = ((idx <= n_acc[:, None]) & (idx < budget[:, None])
              & (live[:, None] > 0))
    eos_hit = ((g == eos_ids[:, None]) & commit).to(torch.int32)
    after = (torch.cumsum(eos_hit, dim=1) - eos_hit) > 0          # strictly after
    valid = (commit & ~after).to(torch.int32)
    n_emit = valid.sum(dim=1).to(torch.int32)
    last = torch.clamp(n_emit - 1, min=0).long()
    final = torch.where(n_emit > 0, torch.gather(g, 1, last[:, None])[:, 0],
                        tokens[:, 0].to(g.dtype))
    return valid, n_emit, final.to(torch.int32)


def _write_mask(S: int, live: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
    """(B, S) int32: the span positions a verify call writes — live slots,
    candidates under the slot's token budget."""
    j = torch.arange(S, device=live.device)[None, :]
    return ((live[:, None] > 0) & (j < budget[:, None])).to(torch.int32)


def spec_verify_logits_paged(cfg: ModelConfig, params: Params, pool: Dict,
                             cache: Dict, tokens: torch.Tensor,
                             live: torch.Tensor, budget: torch.Tensor
                             ) -> torch.Tensor:
    """The scoring half of :func:`spec_verify_paged`: writes the span's K/V
    into the pages (in place) and returns the logits (B, S, V) in f32;
    ``length`` does not move."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    length = cache["length"]
    bt = cache["bt"]
    positions = length[:, None] + torch.arange(S, device=tokens.device)[None, :]
    trash = pool["k"].shape[1] - 1
    s = attn_spec(cfg)
    write_mask = _write_mask(S, live, budget)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        pk, pv = pool["k"][l], pool["v"][l]
        h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = layers.attn_qkv(_sub(lp, "attn_"), s, h, positions)
        kvcache.append_tokens_paged(pk, pv, k, v, bt, length, write_mask, trash)
        kg, vg = kvcache.paged_gather_layer(pk, pv, bt,
                                            out_dtype=kvcache.SLOT_CACHE_DTYPE)
        o = kvcache.spec_verify_attention(q, kg, vg, length, window=cfg.window)
        x = _post_attn(cfg, lp, x, o)
    return _logits(cfg, params, x)


def spec_verify_logits_mixed(cfg: ModelConfig, params: Params, cache: Dict,
                             pool: Dict, tokens: torch.Tensor,
                             use_paged: torch.Tensor, live: torch.Tensor,
                             budget: torch.Tensor) -> torch.Tensor:
    """The scoring half of :func:`spec_verify_mixed` (writes in place,
    logits (B, S, V) in f32, ``length`` unmoved)."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    length = cache["length"]
    bt = cache["bt"]
    positions = length[:, None] + torch.arange(S, device=tokens.device)[None, :]
    trash = pool["k"].shape[1] - 1
    s = attn_spec(cfg)
    write_mask = _write_mask(S, live, budget)
    paged_mask = write_mask * use_paged.to(torch.int32)[:, None]
    sel = use_paged[:, None, None, None] > 0
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        kc, vc = cache["k"][l], cache["v"][l]
        pk, pv = pool["k"][l], pool["v"][l]
        h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = layers.attn_qkv(_sub(lp, "attn_"), s, h, positions)
        kvcache.update_layer_cache_multi(kc, vc, k, v, length, write_mask)
        kvcache.append_tokens_paged(pk, pv, k, v, bt, length, paged_mask, trash)
        kg, vg = kvcache.paged_gather_layer(pk, pv, bt, out_dtype=kc.dtype)
        o_p = kvcache.spec_verify_attention(q, kg, vg, length, window=cfg.window)
        o_c = kvcache.spec_verify_attention(q, kc, vc, length, window=cfg.window)
        x = _post_attn(cfg, lp, x, torch.where(sel, o_p, o_c))
    return _logits(cfg, params, x)


def _spec_commit(cache: Dict, tokens: torch.Tensor, logits: torch.Tensor,
                 live: torch.Tensor, eos_ids: torch.Tensor, budget: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Accept on the logits, move ``length`` by the emitted count in place;
    returns (g, valid, final)."""
    g = torch.argmax(logits, dim=-1).to(torch.int32)               # (B, S)
    valid, n_emit, final = _spec_accept(tokens, g, live, eos_ids, budget)
    cache["length"].add_(n_emit)
    return g, valid, final


def spec_verify_paged(cfg: ModelConfig, params: Params, pool: Dict,
                      cache: Dict, tokens: torch.Tensor, live: torch.Tensor,
                      eos_ids: torch.Tensor, budget: torch.Tensor
                      ) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Score an S-token candidate span a slot in ONE pass over the paged
    layout.

    tokens: (B, S) — [last committed token, draft_1, ..., draft_{S-1}]; the
    caller must have installed pages covering ``[length, length + min(S,
    budget))`` of each live slot (the fused horizon's reservation).  Each
    layer writes the span's under-budget K/V through the block table, then
    one multi-query read over the gathered pages (at the slot-cache dtype,
    as the decode step reads them) scores every row; the accept mask
    commits the longest verified prefix and one correction, and
    ``cache["length"]`` moves by the emitted count, in place.  Returns
    (pool, cache, tok_block (B, S), valid (B, S), final_tok (B,)): the fused
    horizon's contract."""
    logits = spec_verify_logits_paged(cfg, params, pool, cache, tokens, live,
                                      budget)
    g, valid, final = _spec_commit(cache, tokens, logits, live, eos_ids, budget)
    return pool, cache, g, valid, final


def spec_verify_mixed(cfg: ModelConfig, params: Params, cache: Dict,
                      pool: Dict, tokens: torch.Tensor, use_paged: torch.Tensor,
                      live: torch.Tensor, eos_ids: torch.Tensor,
                      budget: torch.Tensor
                      ) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Speculative verify of ``kv_layout="auto"`` (slots in either layout),
    as :func:`decode_step_mixed`: QKV and FFN once, writes to both
    structures (the contiguous one through the masked write of
    :func:`kvcache.update_layer_cache_multi`, the pages only for live paged
    under-budget positions), both reads computed and selected per slot.
    Returns (cache, pool, tok_block, valid, final_tok)."""
    logits = spec_verify_logits_mixed(cfg, params, cache, pool, tokens,
                                      use_paged, live, budget)
    g, valid, final = _spec_commit(cache, tokens, logits, live, eos_ids, budget)
    return cache, pool, g, valid, final
