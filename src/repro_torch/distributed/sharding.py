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

Training on a ``(data, model)`` mesh uses the same split over the model
axis.  Over the data axis each leaf is either replicated (``fsdp`` off) or
cut as the reference's rule table cuts it (``fsdp`` on, the layout the
reference's launcher always trains with): :data:`RULES` is the table's
copy, of which the port reads only the dim the first divisible candidate
gives ``"fsdp"`` (:func:`fsdp_dim`), on the whole leaf at ``(dp, mp)``.
:func:`fsdp_slice` cuts that dim of the rank's model shard; a leaf whose
dim does not divide there, or whose fsdp dim is the port's model-split
dim, stays replicated over ``data`` (the rules' fallback).  Where the
port's model split departs from the rules (``embed`` and ``lm_head``
replicated over ``model``), the fsdp dim is still the rules' (``embed``'s
``d_model``, as in ``("tp", "fsdp")``).
:func:`grad_layout` says how each leaf's gradient is completed on a rank:
a split leaf's slice is whole, except a KV slice several ranks hold
(:data:`KV_GROUP`), whose partials are summed over those ranks; a
replicated leaf is whole, except ``q_norm``/``k_norm`` over split heads
and the MoE ``router`` over split experts or columns, whose partials are
summed over the model group; a leaf cut over ``data`` arrives averaged
over the data group by its gather's backward.  :func:`unshard_leaf` puts a leaf's model parts back together for a
checkpoint (its data slices join on the data cut's dim), which is the
whole tree whatever the mesh.
Families other than dense, moe and vlm keep :func:`shard_plan`'s
``ValueError`` at ``mp > 1`` (the recurrent families' heads are not
split) and train at any ``dp``, with or without fsdp.
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
    """The port's split of ``cfg`` over ``mp`` ranks (module docstring); at
    ``mp = 1`` nothing splits, whatever the family."""
    if mp > 1 and cfg.family not in ("dense", "moe", "vlm"):
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


def _layer_leaf(path: str) -> Optional[str]:
    """The layer leaf's name of ``path`` (``…['layers']['attn_wq']`` in
    params, ``m``, ``v``, the master copy or the error feedback)."""
    m = re.search(r"\['layers'\]\['(\w+)'\]$", path)
    return m.group(1) if m else None


def leaf_slice(cfg: ModelConfig, plan: ShardPlan, rank: int, path: str,
               shape: Tuple[int, ...]) -> Optional[Tuple[int, int, int]]:
    """(dim, start, size) of rank ``rank``'s slice of the whole leaf of
    ``shape`` at ``path``, or None when the rank holds it whole."""
    name = _layer_leaf(path)
    split = _leaf_split(name, plan) if name else None
    if split is None:
        return None
    axis, how = split
    dim = len(shape) + axis
    hd = cfg.head_dim
    if how == "q":
        return dim, rank * plan.q_heads * hd, plan.q_heads * hd
    if how == "kv":
        kv0 = plan.kv_head0(rank, cfg.num_heads, cfg.num_kv_heads)
        return dim, kv0 * hd, plan.kv_heads * hd
    size = shape[dim] // plan.mp
    return dim, rank * size, size


def shard_params(cfg: ModelConfig, params: Any, mp: int, rank: int
                 ) -> Tuple[Any, ModelConfig]:
    """Rank ``rank``'s shard of ``params`` and its shard-local config.
    ``params`` may be any tree whose layer leaves sit under ``['layers']``
    as the params' do (the optimizer's ``m``, ``v``, master copy).

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
    return (map_leaves(params, lambda path, t: cut_leaf(t, rank_cuts(
        cfg, plan, rank, 0, 1, path, tuple(t.shape)))), shard_config(cfg, mp))


def map_leaves(tree: Any, fn) -> Any:
    """``tree`` with each leaf replaced by ``fn(key string, leaf)``."""
    return _unflatten(tree, {path: fn(path, leaf) for path, leaf in _walk(tree)})


def splits_leaf(cfg: ModelConfig, mp: int, path: str) -> bool:
    """Whether the leaf at ``path`` is split over ``mp`` ranks."""
    name = _layer_leaf(path)
    return name is not None and _leaf_split(name, shard_plan(cfg, mp)) is not None


def unshard_leaf(cfg: ModelConfig, mp: int, path: str,
                 parts: List[torch.Tensor]) -> torch.Tensor:
    """The whole leaf at ``path`` from every rank's part (by rank): the
    parts concatenated along the split dim, a slice that several ranks
    hold (:data:`KV_GROUP`) taken once; ``parts[0]`` for a whole leaf."""
    plan = shard_plan(cfg, mp)
    name = _layer_leaf(path)
    split = _leaf_split(name, plan) if name is not None and plan.splits else None
    if split is None:
        return parts[0]
    axis, how = split
    shape = list(parts[0].shape)
    dim = len(shape) + axis
    shape[dim] = (cfg.num_kv_heads * cfg.head_dim if how == "kv" and not plan.kv_even
                  else shape[dim] * mp)
    taken, pieces = set(), []
    for r, part in enumerate(parts):
        start = leaf_slice(cfg, plan, r, path, tuple(shape))[1]
        if start not in taken:
            taken.add(start)
            pieces.append(part)
    return torch.cat(pieces, dim)


# -- gradients on a training mesh ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradLeaf:
    """How a rank completes one leaf's gradient, counts it in the global
    norm and quantizes it in the whole leaf's blocks.

    ``whole`` is the whole leaf's shape and ``cut`` the rank's (dim, start,
    size) of it (None: the rank holds it whole).  ``partial``: None when
    the rank's gradient is already its slice's whole gradient; ``"model"``
    when a replicated leaf gets a partial on each rank (``q_norm`` and
    ``k_norm`` over split heads, the MoE ``router`` over split experts or
    columns), summed over the model group; ``"holders"`` when several
    ranks hold the slice (:data:`KV_GROUP`) and each has a partial, summed
    over those ranks.  ``counted``: whether this rank adds the leaf's
    squares to the model group's sum (a split leaf's slice, once per
    holder group) rather than to its own (a replicated leaf, counted
    once).  ``data``: the (dim, start, size) of the rank's model shard that
    it holds under fsdp (None: the whole shard); its gradient arrives
    averaged over the data group and its squares are summed over it."""
    whole: Tuple[int, ...]
    cut: Optional[Tuple[int, int, int]]
    partial: Optional[str]
    counted: bool
    data: Optional[Tuple[int, int, int]] = None


def grad_layout(cfg: ModelConfig, mp: int, rank: int, tree: Any, *,
                dp: int = 1, d: int = 0) -> Any:
    """A :class:`GradLeaf` for each leaf of the whole ``tree`` (params or
    their shapes), for model rank ``rank`` of ``mp`` and, with ``dp > 1``
    (fsdp on), data rank ``d`` of ``dp``, in ``tree``'s nesting."""
    plan = shard_plan(cfg, mp)
    values = {}
    for path, leaf in _walk(tree):
        shape = _shape(leaf)
        data = fsdp_slice(cfg, plan, d, dp, path, shape)
        name = _layer_leaf(path)
        cut = leaf_slice(cfg, plan, rank, path, shape) if plan.splits else None
        partial, counted = None, cut is not None
        if cut is not None and _leaf_split(name, plan)[1] == "kv" and not plan.kv_even:
            partial = "holders"
            # the first of the ranks that hold this KV head counts it
            counted = rank == 0 or leaf_slice(cfg, plan, rank - 1, path, shape) != cut
        elif cut is None and ((plan.attn and name in ("attn_q_norm", "attn_k_norm"))
                              or (plan.moe and name == "moe_router")):
            partial = "model"
        values[path] = GradLeaf(whole=shape, cut=cut, partial=partial, counted=counted,
                                data=data)
    return _unflatten(tree, values)


# -- the data axis (fsdp) ---------------------------------------------------------------

# The reference's rule table (``repro.distributed.sharding.RULES``): (regex
# on the leaf's key string, candidate spec tails in preference order); a
# candidate wins when each named dim divides by its mesh axis (``tp`` the
# model axis, ``fsdp`` the data axis).  Tails address the trailing dims.
RULES: List[Tuple[str, List[Tuple]]] = [
    (r"embed",            [("tp", "fsdp"), ("fsdp", "tp"), (None, "tp"), (None, None)]),
    (r"lm_head",          [("fsdp", "tp"), ("tp", "fsdp"), ("tp", None), (None, None)]),
    (r"attn_w[qkv]\b|xattn_w[qkv]\b", [("fsdp", "tp"), (None, "tp"), (None, None)]),
    (r"attn_wo\b|xattn_wo\b",         [("tp", "fsdp"), ("tp", None), (None, None)]),
    (r"attn_b[qkv]\b|xattn_b[qkv]\b", [("tp",), (None,)]),
    (r"q_norm|k_norm",    [(None,)]),
    (r"ffn_w_gate|ffn_w_up|mlp_w_in|shared_w_gate|shared_w_up",
                          [("fsdp", "tp"), (None, "tp"), (None, None)]),
    (r"ffn_w_down|mlp_w_out|shared_w_down",
                          [("tp", "fsdp"), ("tp", None), (None, None)]),
    (r"mlp_b_in",         [("tp",), (None,)]),
    (r"mlp_b_out",        [(None,)]),
    (r"moe_router",       [("fsdp", None), (None, None)]),
    (r"experts_gate|experts_up",
                          [("tp", "fsdp", None), (None, "tp", None), (None, "fsdp", None),
                           (None, None, None)]),
    (r"experts_down",     [("tp", None, "fsdp"), (None, None, "tp"), (None, "fsdp", None),
                           (None, None, None)]),
    (r"m_in_proj",        [("fsdp", "tp"), (None, "tp"), (None, None)]),
    (r"m_out_proj",       [("tp", "fsdp"), ("tp", None), (None, None)]),
    (r"m_conv_w",         [(None, "tp"), (None, None)]),
    (r"m_conv_b",         [("tp",), (None,)]),
    (r"m_A_log|m_D|m_dt_bias", [("tp",), (None,)]),
    (r"m_norm",           [("tp",), (None,)]),
    (r"\bwr\b|\bwk\b|\bwv\b|\bwg\b|\bcr\b|\bck\b",
                          [("fsdp", "tp"), (None, "tp"), (None, None)]),
    (r"\bwo\b|\bcv\b",    [("tp", "fsdp"), ("tp", None), (None, None)]),
    (r"w_lora_a",         [("fsdp", None), (None, None)]),
    (r"w_lora_b",         [(None, "tp"), (None, None)]),
    (r"mix_|cmix_|w_base|\bu\b|ln_x", [("tp",), (None,)]),
    (r"ln1|ln2|ln_x|final_norm|enc_norm|dec_norm|m_ln", [(None,)]),
]


def _tail_ok(tail: Tuple, shape: Tuple[int, ...], sizes: Dict[str, int]) -> bool:
    offset = len(shape) - len(tail)
    if offset < 0:
        return False
    return all(t is None or shape[offset + i] % sizes[t] == 0
               for i, t in enumerate(tail))


def fsdp_dim(path: str, shape: Tuple[int, ...], dp: int, mp: int) -> Optional[int]:
    """The dim (counted from the end) that the rules' first divisible
    candidate gives ``"fsdp"`` for the whole leaf of ``shape`` at ``path`` on
    a ``(dp, mp)`` mesh, or None (no candidate names it, or ``dp = 1``)."""
    if dp == 1:
        return None
    sizes = {"fsdp": dp, "tp": mp}
    for pattern, candidates in RULES:
        if re.search(pattern, path):
            for tail in candidates:
                if _tail_ok(tail, shape, sizes):
                    return tail.index("fsdp") - len(tail) if "fsdp" in tail else None
            return None
    return None


def fsdp_slice(cfg: ModelConfig, plan: ShardPlan, d: int, dp: int, path: str,
               shape: Tuple[int, ...]) -> Optional[Tuple[int, int, int]]:
    """(dim, start, size) of data rank ``d``'s slice of the rank's model
    shard of the whole leaf of ``shape`` at ``path`` (module docstring), or
    None where every data rank holds the shard whole."""
    ax = fsdp_dim(path, shape, dp, plan.mp)
    if ax is None:
        return None
    dim = len(shape) + ax
    local = list(shape)
    cut = leaf_slice(cfg, plan, 0, path, shape) if plan.splits else None
    if cut is not None:
        if cut[0] == dim:
            return None
        local[cut[0]] = cut[2]
    if local[dim] % dp:
        return None
    size = local[dim] // dp
    return dim, d * size, size


def rank_cuts(cfg: ModelConfig, plan: ShardPlan, m: int, d: int, dp: int, path: str,
              shape: Tuple[int, ...]) -> List[Tuple[int, int, int]]:
    """The cuts that make rank ``(d, m)``'s slice of the whole leaf of
    ``shape`` at ``path``, in order: the model cut on the whole leaf, then
    the data cut on the model shard (each where it applies)."""
    cuts = []
    cut = leaf_slice(cfg, plan, m, path, shape) if plan.splits else None
    if cut is not None:
        cuts.append(cut)
    data = fsdp_slice(cfg, plan, d, dp, path, shape)
    if data is not None:
        cuts.append(data)
    return cuts


def cut_leaf(t: torch.Tensor, cuts: List[Tuple[int, int, int]]) -> torch.Tensor:
    """``t`` narrowed by each cut in turn, copied where cut: a slice of the
    leading rows is a contiguous view, which ``contiguous()`` would return
    as it is, keeping the whole leaf's storage alive (``lm_head``'s rows
    under fsdp)."""
    for cut in cuts:
        t = t.narrow(*cut)
    return t.clone(memory_format=torch.contiguous_format) if cuts else t
