"""Operations and bytes the inputs need, counted from shapes.

The yardstick of the rooflines and the model-FLOPs shares.  It counts the
work the inputs need, whatever implements it: each input byte read once,
each output byte written once, and for attention only the (query, key)
pairs the mask keeps.  Elementwise work (norms, RoPE, softmax) is not
counted, as model-FLOPs conventions do not.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from portbench import families

INT32 = 4


def causal_pairs(queries: int, keys_before: int, window: Optional[int] = None) -> int:
    """(query, key) pairs a causal mask keeps for ``queries`` rows that sit
    after ``keys_before`` earlier positions (row i sees keys 0 ..
    keys_before + i), under a sliding ``window`` if given."""
    total = 0
    if window is None:
        first = keys_before + 1
        last = keys_before + queries
        return (first + last) * queries // 2
    for i in range(queries):
        total += min(keys_before + i + 1, window)
    return total


def attention_flops(pairs: int, num_heads: int, head_dim: int) -> int:
    """Q.K^T and P.V over ``pairs`` kept pairs: 2 products of 2 FLOPs a
    multiply-add each."""
    return 4 * pairs * num_heads * head_dim


def flash_fwd_ops(batch: int, seq: int, num_heads: int, head_dim: int,
                  window: Optional[int] = None) -> int:
    """Operations of one causal flash-attention forward call over (B, S)."""
    return attention_flops(batch * causal_pairs(seq, 0, window), num_heads, head_dim)


def flash_fwd_bytes(batch: int, seq: int, num_heads: int, num_kv_heads: int,
                    head_dim: int, elt: int = 2) -> int:
    """q, k, v read once and the output written once."""
    return batch * seq * head_dim * elt * (2 * num_heads + 2 * num_kv_heads)


def paged_decode_bytes(lengths: Sequence[int], num_heads: int, num_kv_heads: int,
                       head_dim: int, elt: int = 2, table_entries: int = 0) -> int:
    """One decode-attention call over B slots: each slot's query and output,
    its K and V at ``lengths`` positions, ``table_entries`` int32 page ids
    of the block table and each slot's int32 length."""
    b = len(lengths)
    qo = 2 * b * num_heads * head_dim * elt
    kv = 2 * sum(lengths) * num_kv_heads * head_dim * elt
    return qo + kv + table_entries * INT32 + b * INT32


def paged_prefill_bytes(base: int, chunk: int, num_heads: int, num_kv_heads: int,
                        head_dim: int, elt: int = 2, table_entries: int = 0) -> int:
    """One chunked-prefill attention call: the chunk's queries and output,
    K and V of the ``base + chunk`` positions it attends to,
    ``table_entries`` int32 page ids and the int32 base."""
    qo = 2 * chunk * num_heads * head_dim * elt
    kv = 2 * (base + chunk) * num_kv_heads * head_dim * elt
    return qo + kv + table_entries * INT32 + INT32


def pages(positions: int, block: int) -> int:
    return -(-positions // block)


def paged_prefill_ops(base: int, chunk: int, num_heads: int, head_dim: int,
                      window: Optional[int] = None) -> int:
    return attention_flops(causal_pairs(chunk, base, window), num_heads, head_dim)


def roofline_seconds(ops: float, nbytes: float, flops_peak: float,
                     bytes_peak: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / flops_peak, nbytes / bytes_peak)


# -- the model steps (the weights from the configuration's family) -------------

def layer_matmul_params(cfg) -> int:
    """Weights one token multiplies in one layer, as ``cfg``'s family
    counts them (``families/<family>.py``)."""
    return families.program(cfg.family).layer_matmul_params(cfg)


def token_flops(cfg, context: int, logits: bool) -> int:
    """Model FLOPs of one token through the whole model, attending to
    ``context`` keys, as ``cfg``'s family counts them."""
    return families.program(cfg.family).token_flops(cfg, context, logits)


def decode_step_flops(cfg, positions: Iterable[int]) -> int:
    """One decode step: each decoding slot's token at its position attends
    to ``position + 1`` keys and needs its logits."""
    return sum(token_flops(cfg, p + 1, True) for p in positions)


def prefill_chunk_flops(cfg, base: int, chunk: int) -> int:
    """One prefill chunk of ``chunk`` real tokens after ``base`` positions:
    the weights for every token, causal attention, and the logits of its
    last position only."""
    flops = 2 * layer_matmul_params(cfg) * cfg.num_layers * chunk
    pairs = causal_pairs(chunk, base, cfg.window)
    flops += attention_flops(pairs, cfg.num_heads, cfg.head_dim) * cfg.num_layers
    return flops + 2 * cfg.d_model * cfg.vocab_size


def train_step_flops(cfg, n_params: int, batch: int, seq: int) -> int:
    """Model FLOPs of one training step (``chip_smoke.py``'s ``train_flops``,
    copied): 6 * params * tokens for the weights, and 12 * D * Hq per kept
    (query, key) pair per layer for attention (two products forward, twice
    that backward; no recomputation counted)."""
    pairs = causal_pairs(seq, 0, cfg.window)
    attn = 12 * cfg.head_dim * cfg.num_heads * pairs * cfg.num_layers * batch
    return 6 * n_params * batch * seq + attn
