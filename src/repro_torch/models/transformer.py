"""Decoder-only transformer, dense family: parameters, the whole-sequence
training forward and the paged serving steps.

The counterpart of the dense half of ``repro.models.transformer``.  The
parameter dict has the reference's layout — per-layer weights stacked on a
leading L axis under ``params["layers"]`` — and the steps walk the layers
in a Python loop where the reference scans (``params["layers"][name][l]``
is a view, so the loop copies no weights).  The training forward splits
each stack once with ``torch.unbind`` instead: under autograd, indexing
``W[l]`` per layer would make every layer's backward add a zero-filled
gradient of the whole stack, while ``unbind``'s backward stacks the
per-layer gradients once.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

from . import kvcache, layers
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


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# -- parameter shapes -------------------------------------------------------------

def layer_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    s = attn_spec(cfg)
    shapes: Dict[str, Tuple] = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    shapes.update({f"attn_{k}": v for k, v in layers.attn_param_shapes(s).items()})
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

def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters on ``gen``'s device, drawn from ``gen``: the same
    distributions as the reference's ``init_params`` (not the same
    numbers — parity tests convert the reference's parameters instead,
    :mod:`repro_torch.models.convert`)."""
    dt = _dtype(cfg)
    dev = gen.device
    s = attn_spec(cfg)
    # filled layer by layer: a full-width model never holds two copies
    stacked = {k: torch.empty((cfg.num_layers, *shape), dtype=dt, device=dev)
               for k, shape in layer_param_shapes(cfg).items()}
    for l in range(cfg.num_layers):
        p: Params = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                     "ln2": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
        p.update({f"attn_{k}": v for k, v in layers.init_attn(gen, s, dt).items()})
        p.update({f"ffn_{k}": v for k, v in
                  layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt).items()})
        for k, v in p.items():
            stacked[k][l] = v
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev)
    params: Params = {
        "embed": embed.mul_(0.02).to(dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "layers": stacked,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    return params


# -- training forward ----------------------------------------------------------------

def layer_fwd(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    s = attn_spec(cfg)
    h = layers.rmsnorm(x, p["ln1"], cfg.rms_eps)
    x = x + layers.attn_block(_sub(p, "attn_"), s, h, positions, causal=True,
                              attn_impl=cfg.attn_impl)
    h = layers.rmsnorm(x, p["ln2"], cfg.rms_eps)
    return x + layers.swiglu(_sub(p, "ffn_"), h)


def _unbind_layers(stacked: Params, num_layers: int) -> list:
    """Per-layer dicts of views, one ``unbind`` per stacked weight."""
    split = {k: torch.unbind(v, 0) for k, v in stacked.items()}
    return [{k: split[k][l] for k in stacked} for l in range(num_layers)]


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in f32.  ``cfg.remat == "full"``
    recomputes each layer in the backward pass (non-reentrant
    ``torch.utils.checkpoint``), keeping only the layer inputs — the
    counterpart of the reference's ``jax.checkpoint`` around the scan
    body."""
    B, S = tokens.shape
    x = F.embedding(tokens.long(), params["embed"])
    positions = torch.arange(S, device=tokens.device)
    for lp in _unbind_layers(params["layers"], cfg.num_layers):
        if cfg.remat == "full":
            x = checkpoint(layer_fwd, cfg, lp, x, positions, use_reentrant=False)
        else:
            x = layer_fwd(cfg, lp, x, positions)
    return _logits(cfg, params, x)


# -- serving ------------------------------------------------------------------------

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


def _sub(p: Params, prefix: str) -> Params:
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


def _layer_kv_fwd(cfg: ModelConfig, s: AttnSpec, lp: Params, x: torch.Tensor,
                  positions: torch.Tensor, attn_call
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prompt-pass layer; returns (x_out, k, v).  ``attn_call(q, k, v)``
    is the chunk attention (gather or kernel backend)."""
    h = layers.rmsnorm(x, lp["ln1"], cfg.rms_eps)
    q, k, v = layers.attn_qkv(_sub(lp, "attn_"), s, h, positions)
    o = attn_call(q, k, v)
    x = x + layers._merge_heads(o) @ lp["attn_wo"]
    h = layers.rmsnorm(x, lp["ln2"], cfg.rms_eps)
    return x + layers.swiglu(_sub(lp, "ffn_"), h), k, v


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
    x = layers.rmsnorm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


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
    """Output projection + FFN half of a decode layer."""
    x = x + layers._merge_heads(o) @ lp["attn_wo"]
    h = layers.rmsnorm(x, lp["ln2"], cfg.rms_eps)
    return x + layers.swiglu(_sub(lp, "ffn_"), h)


def decode_step_paged(cfg: ModelConfig, params: Params, pool: Dict,
                      cache: Dict, tokens: torch.Tensor, live: torch.Tensor,
                      decode_impl: Optional[str] = None
                      ) -> Tuple[Dict, Dict, torch.Tensor]:
    """One decode step over the PAGED KV layout.

    pool: {"k","v"} (L, N, Hkv, bs, D) (last row = trash), updated in
    place; cache: {"bt": (B, nb) int32, "length": (B,) int32}; tokens:
    (B, 1); live: (B,) int mask (0 = free or prefilling slot — its write
    goes to the trash page).

    Per layer: append the new token's K/V into each live slot's tail page,
    then attend through the block table — by gathering the pages at the
    slot-cache dtype (``grouped``/``flat``), or in place through the decode
    kernel (``cuda``, reading through the same dtype).  Returns (pool,
    cache with every length advanced by one, logits (B, 1, V))."""
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

    return pool, {"bt": bt, "length": length + 1}, _logits(cfg, params, x)
