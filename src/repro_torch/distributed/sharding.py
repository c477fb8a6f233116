"""Head sharding of the serve engine over ``mp`` ranks: the shard each rank
holds.

The reference (``repro.distributed.sharding``) is one JAX process: its
rule table gives every leaf a spec on the serve mesh ``('dp', 'mp')``,
GSPMD places it and XLA inserts the collectives.  The port runs one
process a rank (:mod:`repro_torch.distributed.group`) and splits whole
heads and whole blocks, so that each rank runs the same forward code over
its slice and one all-reduce after each down-projection completes the sum
(:func:`shard_plan`, :func:`shard_params`):

* attention splits when every rank's query heads read whole KV heads:
  ``Hq % mp == 0`` and ``Hq/mp`` a multiple or a divisor of the group
  ``G = Hq/Hkv``.  With ``Hkv % mp == 0`` the KV heads split evenly;
  otherwise each rank holds the one KV head its query heads read.  Either
  way a rank's page pool holds the KV heads of its own query heads, which
  is all the paged kernels need, so they run on every shard at its head
  counts;
* the dense FFN splits its hidden dim when ``d_ff % mp == 0``;
* the MoE block splits its experts when the (padded) expert count divides,
  else each expert's hidden columns when ``moe_d_ff % mp == 0``; the shared
  expert splits its columns;
* a block that cannot split so is replicated: every rank computes it
  whole and no all-reduce follows it, so any ``mp`` is correct;
* ``embed``, ``lm_head`` and the norms are replicated: every rank has the
  whole logits and takes the same greedy token.

Where these differ from the reference's rules (``embed`` and ``lm_head``,
whose vocabulary axis the rules split; a split inside a head, which the
rules allow when ``H * head_dim`` divides but ``H`` does not; KV heads
held by the query heads that read them, where the reference replicates
the pool and runs the gather path), the layout departs from the
reference's and the numbers do not: :func:`shard_specs` gives the specs
the port applies, in the reference's form, for the tests to hold against
its ``param_specs`` and ``serve_kv_spec``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

MP = "mp"
# the spec entry of a KV weight whose heads are not split evenly: each
# rank holds the KV heads its query heads read (several ranks the same)
KV_GROUP = "mp:kv-group"


def _walk(tree: Any, path: str = ""):
    """(key string, leaf) of a nested dict whose leaves are tensors or
    shape tuples, in the reference's ``keystr`` form."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def _shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else tuple(leaf)


def _unflatten(tree: Any, values: Dict[str, Any], path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{path}[{k!r}]") for k, v in tree.items()}
    return values[path]


# -- the port's split: whole heads, whole blocks ------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How a model splits over ``mp`` ranks.  ``attn``: the attention block
    splits its query heads (``q_heads`` a rank) and each rank holds
    ``kv_heads`` KV heads, evenly split when ``kv_even`` (else the one its
    query heads read); ``ffn``: the dense FFN or the MoE block splits
    (``moe`` is ``"experts"`` or ``"columns"`` for the MoE block)."""
    mp: int
    attn: bool
    q_heads: int
    kv_heads: int
    kv_even: bool
    ffn: bool
    moe: Optional[str] = None

    @property
    def splits(self) -> bool:
        return self.attn or self.ffn

    def kv_head0(self, rank: int, num_heads: int, num_kv_heads: int) -> int:
        """The first KV head rank ``rank`` holds."""
        if not self.attn:
            return 0
        if self.kv_even:
            return rank * self.kv_heads
        return rank * self.q_heads // (num_heads // num_kv_heads)


def shard_plan(cfg: ModelConfig, mp: int) -> ShardPlan:
    """The port's split of ``cfg`` over ``mp`` ranks (module docstring)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"head sharding serves the transformer families; "
                         f"{cfg.name} is {cfg.family!r}")
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    group = Hq // Hkv
    hq = Hq // mp if Hq % mp == 0 else 0
    attn = mp > 1 and hq > 0 and (hq % group == 0 or group % hq == 0)
    kv_even = attn and Hkv % mp == 0
    kv_heads = (Hkv // mp if kv_even else 1) if attn else Hkv
    moe = None
    if cfg.family == "moe":
        from repro_torch.models.transformer import moe_spec
        s = moe_spec(cfg)
        shared_ok = s.num_shared_experts == 0 or s.shared_d_ff % mp == 0
        if mp > 1 and shared_ok:
            if s.padded_experts % mp == 0:
                moe = "experts"
            elif s.moe_d_ff % mp == 0:
                moe = "columns"
        ffn = moe is not None
    else:
        ffn = mp > 1 and cfg.d_ff % mp == 0
    return ShardPlan(mp=mp, attn=attn, q_heads=hq if attn else Hq,
                     kv_heads=kv_heads, kv_even=kv_even, ffn=ffn, moe=moe)


def _leaf_split(name: str, plan: ShardPlan) -> Optional[Tuple[int, str]]:
    """(the axis of a layer leaf, counted from the end, that splits, and how)
    for ``params["layers"][name]``, or None when it is whole on every
    rank.  How: ``"q"`` query-head columns or rows, ``"kv"`` KV-head
    columns, ``"ffn"`` even hidden columns or rows, ``"experts"`` the
    expert axis."""
    if plan.attn:
        if name in ("attn_wq", "attn_bq"):
            return -1, "q"
        if name == "attn_wo":
            return -2, "q"
        if name in ("attn_wk", "attn_wv", "attn_bk", "attn_bv"):
            return -1, "kv"
    if plan.ffn:
        if name in ("ffn_w_gate", "ffn_w_up", "moe_shared_w_gate", "moe_shared_w_up"):
            return -1, "ffn"
        if name in ("ffn_w_down", "moe_shared_w_down"):
            return -2, "ffn"
        if name in ("moe_experts_gate", "moe_experts_up", "moe_experts_down"):
            if plan.moe == "experts":
                return -3, "experts"
            return (-1 if name != "moe_experts_down" else -2), "ffn"
    return None


def shard_specs(cfg: ModelConfig, tree: Any, mp: int) -> Any:
    """The specs :func:`shard_params` applies to ``tree`` (params or their
    shapes), in the form of the reference's ``param_specs``: ``"mp"`` on
    the dim that
    splits evenly, :data:`KV_GROUP` on a KV weight's dim when ranks hold
    the KV heads their query heads read, ``None`` elsewhere."""
    plan = shard_plan(cfg, mp)
    values = {}
    for path, leaf in _walk(tree):
        shape = _shape(leaf)
        dims: List[Optional[str]] = [None] * len(shape)
        m = re.fullmatch(r"\['layers'\]\['(\w+)'\]", path)
        split = _leaf_split(m.group(1), plan) if m else None
        if split is not None:
            axis, how = split
            dims[axis] = KV_GROUP if how == "kv" and not plan.kv_even else MP
        values[path] = tuple(dims)
    return _unflatten(tree, values)


def shard_config(cfg: ModelConfig, mp: int) -> ModelConfig:
    """The shard-local config: the heads, FFN hidden width and expert
    hidden width one rank holds (the expert count stays whole: every rank
    routes over all experts)."""
    plan = shard_plan(cfg, mp)
    kw: Dict[str, Any] = {}
    if plan.attn:
        kw.update(num_heads=plan.q_heads, num_kv_heads=plan.kv_heads)
    if plan.moe == "columns":
        kw["moe_d_ff"] = cfg.moe_d_ff // mp
    elif plan.ffn and cfg.family != "moe":
        kw["d_ff"] = cfg.d_ff // mp
    return dataclasses.replace(cfg, **kw)


def shard_params(cfg: ModelConfig, params: Any, mp: int, rank: int
                 ) -> Tuple[Any, ModelConfig]:
    """Rank ``rank``'s shard of ``params`` and its shard-local config.

    Split leaves are copied (contiguous, on the leaves' device), so the
    caller may drop the whole parameters; replicated leaves are the
    caller's tensors, shared.  With no split at all (``mp = 1``, or a
    model nothing of which splits) the parameters come back as they
    are."""
    if not 0 <= rank < mp:
        raise ValueError(f"rank {rank} outside a mesh of mp={mp}")
    plan = shard_plan(cfg, mp)
    if not plan.splits:
        return params, cfg
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv0 = plan.kv_head0(rank, Hq, Hkv)
    ranges = {
        "q": (rank * plan.q_heads * hd, plan.q_heads * hd),
        "kv": (kv0 * hd, plan.kv_heads * hd),
    }
    layers = {}
    for name, t in params["layers"].items():
        split = _leaf_split(name, plan)
        if split is None:
            layers[name] = t
            continue
        axis, how = split
        if how in ranges:
            start, size = ranges[how]
        else:
            size = t.shape[axis] // mp
            start = rank * size
        layers[name] = t.narrow(t.ndim + axis, start, size).contiguous()
    local = {k: v for k, v in params.items() if k != "layers"}
    local["layers"] = layers
    return local, shard_config(cfg, mp)
