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
over the data group by its gather's backward.  :func:`unshard_leaf` puts
a leaf's model parts back together for a checkpoint (its data slices join
on the data cut's dim), which is the whole tree whatever the mesh.

The recurrent and encoder-decoder families split the same way, whole
heads and whole blocks (:data:`ShardPlan.mixer`):

* ssm (RWKV6): the time-mix splits its heads (``wr``, ``wk``, ``wv``,
  ``wg``, ``w_lora_b`` by head columns, ``w_base``, ``u``, ``ln_x`` by
  head, ``wo`` by rows, then the sum); ``mix_*`` and ``w_lora_a`` stay
  whole, and so does the token-shift state; the channel-mix splits ``ck``
  columns and ``cv`` rows, ``cr`` (whose sigmoid multiplies the completed
  sum) and ``cmix_*`` stay whole;
* hybrid (Mamba2 + the shared block): Mamba2 splits its heads: the z, x
  and dt columns of ``m_in_proj``, the x channels of ``m_conv_*``,
  ``m_A_log``, ``m_D``, ``m_dt_bias``, ``m_norm`` by head, ``m_out_proj``
  by rows; the B and C columns and their conv channels (one group) are
  whole on every rank, so a rank's slice of ``m_in_proj`` and ``m_conv_*``
  is several ranges of the whole leaf (:class:`Runs`); the shared block
  splits as a transformer layer does;
* encdec: self- and cross-attention by head (cross K/V read the
  encoder's output), the GELU MLP by hidden columns (``mlp_w_in``,
  ``mlp_b_in``) and rows (``mlp_w_out``); ``mlp_b_out`` is added once,
  after the sum.

The two norms over split channels, RWKV6's ``ln_x`` and Mamba2's gated
``norm``, stay RMSNorms over the whole row (``layers.rmsnorm_split``: an
f32 sum of squares summed over the model group, forward and backward).
Departures from the rules (recorded in the roadmap): ``mix_*``, ``cr``
and the B/C columns whole on every rank where the rules split them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShardConfig

MP = "mp"
# the spec entry of a KV weight whose heads are not split evenly: each
# rank holds the KV heads its query heads read (several ranks the same)
KV_GROUP = "mp:kv-group"
# the spec entry of a dim cut in several ranges, some of which every rank
# holds (Mamba2's in_proj columns and conv channels: Runs)
MP_RUNS = "mp:runs"


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
    query heads read); ``ffn``: the dense FFN, the MoE block, RWKV6's
    channel-mix or the encoder-decoder's GELU MLP splits (``moe`` is
    ``"experts"`` or ``"columns"`` for the MoE block); ``mixer``: the
    recurrent mixer (RWKV6's time-mix, Mamba2) splits its heads,
    ``mixer_heads`` a rank."""
    mp: int
    attn: bool
    q_heads: int
    kv_heads: int
    kv_even: bool
    ffn: bool
    moe: Optional[str] = None
    family: str = "dense"
    mixer: bool = False
    mixer_heads: int = 0

    @property
    def splits(self) -> bool:
        return self.attn or self.ffn or self.mixer

    def kv_head0(self, rank: int, num_heads: int, num_kv_heads: int) -> int:
        """The first KV head rank ``rank`` holds."""
        if not self.attn:
            return 0
        if self.kv_even:
            return rank * self.kv_heads
        return rank * self.q_heads // (num_heads // num_kv_heads)


def mixer_heads(cfg: ModelConfig) -> int:
    """The recurrent mixer's heads of the whole model: RWKV6's ``d_model /
    rwkv_head_dim``, Mamba2's ``ssm_expand * d_model / ssm_head_dim`` (0 for
    the other families).  Its specs derive them from ``d_model``, not from
    ``num_heads``."""
    if cfg.family == "ssm":
        return cfg.d_model // cfg.rwkv_head_dim
    if cfg.family == "hybrid":
        return cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    return 0


def shard_plan(cfg: ModelConfig, mp: int) -> ShardPlan:
    """The port's split of ``cfg`` over ``mp`` ranks (module docstring); at
    ``mp = 1`` nothing splits, whatever the family."""
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    group = Hq // Hkv
    hq = Hq // mp if Hq % mp == 0 else 0
    attn = (mp > 1 and not cfg.attention_free and hq > 0
            and (hq % group == 0 or group % hq == 0))
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
    H = mixer_heads(cfg)
    mixer = mp > 1 and H > 0 and H % mp == 0
    return ShardPlan(mp=mp, attn=attn, q_heads=hq if attn else Hq,
                     kv_heads=kv_heads, kv_even=kv_even, ffn=ffn, moe=moe,
                     family=cfg.family, mixer=mixer,
                     mixer_heads=H // mp if mixer else H)


# the leaves each block splits, by family: name -> (axis counted from the
# end, how); how: "q" query-head columns or rows, "kv" KV-head columns,
# "even" an even cut, "experts" the expert axis (the MoE block's own
# rules are in _leaf_split), "in_proj" / "conv" Mamba2's runs (Runs)
_ATTN = {f"{p}_{n}": (ax, how) for p in ("attn", "xattn")
         for n, (ax, how) in (("wq", (-1, "q")), ("bq", (-1, "q")), ("wo", (-2, "q")),
                              ("wk", (-1, "kv")), ("wv", (-1, "kv")),
                              ("bk", (-1, "kv")), ("bv", (-1, "kv")))}
_FFN = {
    "ffn_w_gate": (-1, "even"), "ffn_w_up": (-1, "even"), "ffn_w_down": (-2, "even"),
    "mlp_w_in": (-1, "even"), "mlp_b_in": (-1, "even"), "mlp_w_out": (-2, "even"),
    "ck": (-1, "even"), "cv": (-2, "even"),
}
_MIXER = {
    "ssm": {**{n: (-1, "even") for n in ("wr", "wk", "wv", "wg", "w_lora_b", "w_base",
                                          "u", "ln_x")},
            "wo": (-2, "even")},
    "hybrid": {"m_in_proj": (-1, "in_proj"), "m_conv_w": (-1, "conv"),
               "m_conv_b": (-1, "conv"), "m_A_log": (-1, "even"), "m_D": (-1, "even"),
               "m_dt_bias": (-1, "even"), "m_norm": (-1, "even"),
               "m_out_proj": (-2, "even")},
}
# replicated leaves whose gradient is a partial on each rank when the
# block splits: RWKV6's mixes and decay LoRA input, read before the split
# heads (the time-mix's input gradient is summed once, at its entry)
_PARTIAL = {"mixer": ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "w_lora_a"),
            "attn": ("attn_q_norm", "attn_k_norm"), "moe": ("moe_router",)}


def _leaf_split(name: str, plan: ShardPlan) -> Optional[Tuple[int, str]]:
    """(the axis of a layer leaf, counted from the end, that splits, and how)
    for the leaf ``name`` of a layer stack, or None when it is whole on
    every rank (the tables above)."""
    if plan.attn and name in _ATTN:
        return _ATTN[name]
    if plan.mixer and name in _MIXER.get(plan.family, {}):
        return _MIXER[plan.family][name]
    if plan.ffn:
        if name in _FFN:
            return _FFN[name]
        if name in ("moe_shared_w_gate", "moe_shared_w_up"):
            return -1, "even"
        if name == "moe_shared_w_down":
            return -2, "even"
        if name in ("moe_experts_gate", "moe_experts_up", "moe_experts_down"):
            if plan.moe == "experts":
                return -3, "experts"
            return (-1 if name != "moe_experts_down" else -2), "even"
    return None


def shard_specs(cfg: ModelConfig, tree: Any, mp: int) -> Any:
    """The specs :func:`shard_params` applies to ``tree`` (params or their
    shapes), in the form of the reference's ``param_specs``: ``"mp"`` on
    the dim that
    splits evenly, :data:`KV_GROUP` on a KV weight's dim when ranks hold
    the KV heads their query heads read, :data:`MP_RUNS` on a dim cut in
    several ranges (:class:`Runs`), ``None`` elsewhere."""
    plan = shard_plan(cfg, mp)
    values = {}
    for path, leaf in _walk(tree):
        shape = _shape(leaf)
        dims: List[Optional[str]] = [None] * len(shape)
        name = _layer_leaf(path)
        split = _leaf_split(name, plan) if name else None
        if split is not None:
            axis, how = split
            dims[axis] = (KV_GROUP if how == "kv" and not plan.kv_even
                          else MP_RUNS if how in ("in_proj", "conv") else MP)
        values[path] = tuple(dims)
    return _unflatten(tree, values)


def shard_config(cfg: ModelConfig, mp: int) -> ModelConfig:
    """The shard-local config: the heads, FFN hidden width and expert
    hidden width one rank holds (the expert count stays whole: every rank
    routes over all experts); where the recurrent mixer splits, a
    :class:`~repro_torch.configs.base.ShardConfig` whose ``mixer_shards``
    divides the heads its specs derive from ``d_model``."""
    plan = shard_plan(cfg, mp)
    kw: Dict[str, Any] = {}
    if plan.attn:
        kw.update(num_heads=plan.q_heads, num_kv_heads=plan.kv_heads)
    if plan.moe == "columns":
        kw["moe_d_ff"] = cfg.moe_d_ff // mp
    elif plan.ffn and cfg.family != "moe":
        kw["d_ff"] = cfg.d_ff // mp
    local = dataclasses.replace(cfg, **kw)
    if plan.mixer:
        local = ShardConfig(**{f.name: getattr(local, f.name)
                               for f in dataclasses.fields(ModelConfig)},
                            mixer_shards=mp)
    return local


# the stacks whose leaves are a layer's (a hybrid's macro stack has two
# leading dims, its shared block none)
_LEAF = re.compile(r"\['(layers|macro|tail|shared|encoder|decoder)'\]\['(\w+)'\]$")


def _layer_leaf(path: str) -> Optional[str]:
    """The layer leaf's name of ``path`` (``…['layers']['attn_wq']`` in
    params, ``m``, ``v``, the master copy or the error feedback; also under
    a hybrid's ``['macro']``, ``['tail']``, ``['shared']`` and an
    encoder-decoder's ``['encoder']``, ``['decoder']``)."""
    m = _LEAF.search(path)
    return m.group(2) if m else None


@dataclasses.dataclass(frozen=True)
class Runs:
    """A rank's slice along ``dim`` that is several ranges of the whole leaf
    (Mamba2's ``m_in_proj``: its z, x and dt columns and the B/C columns
    every rank holds; ``m_conv_*``: its x channels and B/C): ``runs``, the
    (start, size) of each range in the whole leaf, in the slice's order;
    ``shared``, whether every model rank holds that range.  A one-range
    cut is a plain ``(dim, start, size)``."""
    dim: int
    runs: Tuple[Tuple[int, int], ...]
    shared: Tuple[bool, ...]

    @property
    def size(self) -> int:
        return sum(n for _, n in self.runs)


Cut = Any   # a (dim, start, size) tuple or a Runs


def cut_dim_size(cut: Cut) -> Tuple[int, int]:
    """(dim, size of the slice along it) of a cut."""
    return (cut.dim, cut.size) if isinstance(cut, Runs) else (cut[0], cut[2])


def cut_shape(shape: Tuple[int, ...], cuts: List[Cut]) -> Tuple[int, ...]:
    """``shape`` after each cut in turn."""
    shape = list(shape)
    for cut in cuts:
        dim, size = cut_dim_size(cut)
        shape[dim] = size
    return tuple(shape)


def narrow(t: torch.Tensor, cut: Cut) -> torch.Tensor:
    """The slice of ``t`` a cut gives (a view of one range; several ranges
    are concatenated, a copy)."""
    if isinstance(cut, Runs):
        return torch.cat([t.narrow(cut.dim, s, n) for s, n in cut.runs], cut.dim)
    return t.narrow(*cut)


def place(whole: torch.Tensor, cut: Cut, part: torch.Tensor) -> None:
    """Write ``part`` where ``cut`` took it from ``whole``, in place."""
    if not isinstance(cut, Runs):
        whole.narrow(*cut).copy_(part)
        return
    at = 0
    for s, n in cut.runs:
        whole.narrow(cut.dim, s, n).copy_(part.narrow(cut.dim, at, n))
        at += n


def cut_index(cut: Cut, device=None) -> torch.Tensor:
    """The indices along the cut's dim, in the leaf it cuts, of the slice's
    elements, in order."""
    runs = cut.runs if isinstance(cut, Runs) else ((cut[1], cut[2]),)
    return torch.cat([torch.arange(s, s + n, device=device) for s, n in runs])


def _mamba_runs(cfg: ModelConfig, plan: ShardPlan, rank: int, dim: int,
                how: str) -> Runs:
    """Rank ``rank``'s ranges of Mamba2's ``in_proj`` columns [z | x | B C |
    dt] or conv channels [x | B C]: its heads' share of z, x and dt, and
    the whole B/C group."""
    D, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    di, h = D // plan.mp, plan.mixer_heads
    if how == "in_proj":
        runs = ((rank * di, di), (D + rank * di, di), (2 * D, 2 * N),
                (2 * D + 2 * N + rank * h, h))
        return Runs(dim, runs, (False, False, True, False))
    return Runs(dim, ((rank * di, di), (D, 2 * N)), (False, True))


def leaf_slice(cfg: ModelConfig, plan: ShardPlan, rank: int, path: str,
               shape: Tuple[int, ...]) -> Optional[Cut]:
    """(dim, start, size) of rank ``rank``'s slice of the whole leaf of
    ``shape`` at ``path`` (a :class:`Runs` where it is several ranges), or
    None when the rank holds it whole."""
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
    if how in ("in_proj", "conv"):
        return _mamba_runs(cfg, plan, rank, dim, how)
    size = shape[dim] // plan.mp
    return dim, rank * size, size


def shard_params(cfg: ModelConfig, params: Any, mp: int, rank: int
                 ) -> Tuple[Any, ModelConfig]:
    """Rank ``rank``'s shard of ``params`` and its shard-local config.
    ``params`` may be any tree whose layer leaves sit under their stacks'
    keys as the params' do (the optimizer's ``m``, ``v``, master copy).

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


def whole_shape(cfg: ModelConfig, path: str) -> Tuple[int, ...]:
    """The whole shape of the layer leaf at ``path`` (in any params-shaped
    tree), from the model's ``param_shapes``."""
    from repro_torch.models.model import param_shapes
    m = _LEAF.search(path)
    return tuple(param_shapes(cfg)[m.group(1)][m.group(2)])


def unshard_leaf(cfg: ModelConfig, mp: int, path: str,
                 parts: List[torch.Tensor]) -> torch.Tensor:
    """The whole leaf at ``path`` from every rank's part (by rank): each
    part written where its rank's slice lies (a slice that several ranks
    hold, :data:`KV_GROUP` or a shared :class:`Runs` range, written by each,
    the same values); ``parts[0]`` for a whole leaf."""
    plan = shard_plan(cfg, mp)
    if not plan.splits or not splits_leaf(cfg, mp, path):
        return parts[0]
    shape = list(parts[0].shape)
    dim = cut_dim_size(leaf_slice(cfg, plan, 0, path, whole_shape(cfg, path)))[0]
    shape[dim] = whole_shape(cfg, path)[dim]
    whole = parts[0].new_empty(shape)
    for r, part in enumerate(parts):
        place(whole, leaf_slice(cfg, plan, r, path, tuple(shape)), part)
    return whole


# -- gradients on a training mesh ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradLeaf:
    """How a rank completes one leaf's gradient, counts it in the global
    norm and quantizes it in the whole leaf's blocks.

    ``whole`` is the whole leaf's shape and ``cut`` the rank's (dim, start,
    size) of it, or its :class:`Runs` (None: the rank holds it whole).
    ``partial``: None when
    the rank's gradient is already its slice's whole gradient; ``"model"``
    when a replicated leaf gets a partial on each rank (``q_norm`` and
    ``k_norm`` over split heads, the MoE ``router`` over split experts or
    columns, RWKV6's ``mix_*`` and ``w_lora_a`` over split heads), summed
    over the model group; ``"holders"`` when several
    ranks hold the slice (:data:`KV_GROUP`) and each has a partial, summed
    over those ranks.  ``shared``: the (dim, ranges in the rank's slice) of
    a :class:`Runs` cut that every model rank holds (Mamba2's B/C columns
    and channels), whose gradients are partials summed over the model
    group and counted in the norm once.  ``counted``: whether this rank
    adds the leaf's squares to the model group's sum (a split leaf's slice,
    once per
    holder group) rather than to its own (a replicated leaf, counted
    once).  ``data``: the (dim, start, size) of the rank's model shard that
    it holds under fsdp (None: the whole shard); its gradient arrives
    averaged over the data group and its squares are summed over it."""
    whole: Tuple[int, ...]
    cut: Optional[Cut]
    partial: Optional[str]
    counted: bool
    data: Optional[Tuple[int, int, int]] = None
    shared: Optional[Tuple[int, Tuple[Tuple[int, int], ...]]] = None

    def own_and_shared(self, g: torch.Tensor) -> Tuple[List[torch.Tensor],
                                                       List[torch.Tensor]]:
        """The rank's gradient ``g`` in the parts this rank owns and the
        ranges every model rank holds (``shared``)."""
        if self.shared is None:
            return [g], []
        dim, runs = self.shared
        own, shared, at = [], [], 0
        for s, n in runs:
            if s > at:
                own.append(g.narrow(dim, at, s - at))
            shared.append(g.narrow(dim, s, n))
            at = s + n
        if at < g.shape[dim]:
            own.append(g.narrow(dim, at, g.shape[dim] - at))
        return own, shared


def grad_layout(cfg: ModelConfig, mp: int, rank: int, tree: Any, *,
                dp: int = 1, d: int = 0) -> Any:
    """A :class:`GradLeaf` for each leaf of the whole ``tree`` (params or
    their shapes), for model rank ``rank`` of ``mp`` and, with ``dp > 1``
    (fsdp on), data rank ``d`` of ``dp``, in ``tree``'s nesting."""
    plan = shard_plan(cfg, mp)
    partial_names = {n for block, names in _PARTIAL.items()
                     if getattr(plan, block) for n in names}
    values = {}
    for path, leaf in _walk(tree):
        shape = _shape(leaf)
        data = fsdp_slice(cfg, plan, d, dp, path, shape)
        name = _layer_leaf(path)
        cut = leaf_slice(cfg, plan, rank, path, shape) if plan.splits else None
        partial, counted, shared = None, cut is not None, None
        if cut is not None and _leaf_split(name, plan)[1] == "kv" and not plan.kv_even:
            partial = "holders"
            # the first of the ranks that hold this KV head counts it
            counted = rank == 0 or leaf_slice(cfg, plan, rank - 1, path, shape) != cut
        elif cut is None and name in partial_names:
            partial = "model"
        elif isinstance(cut, Runs):
            at, local = 0, []
            for (_, n), sh in zip(cut.runs, cut.shared):
                if sh:
                    local.append((at, n))
                at += n
            shared = (cut.dim, tuple(local))
        values[path] = GradLeaf(whole=shape, cut=cut, partial=partial, counted=counted,
                                data=data, shared=shared)
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
        cdim, csize = cut_dim_size(cut)
        if cdim == dim:
            return None
        local[cdim] = csize
    if local[dim] % dp:
        return None
    size = local[dim] // dp
    return dim, d * size, size


def rank_cuts(cfg: ModelConfig, plan: ShardPlan, m: int, d: int, dp: int, path: str,
              shape: Tuple[int, ...]) -> List[Cut]:
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


def cut_leaf(t: torch.Tensor, cuts: List[Cut]) -> torch.Tensor:
    """``t`` narrowed by each cut in turn, copied where cut: a slice of the
    leading rows is a contiguous view, which ``contiguous()`` would return
    as it is, keeping the whole leaf's storage alive (``lm_head``'s rows
    under fsdp)."""
    for cut in cuts:
        t = narrow(t, cut)
    return t.clone(memory_format=torch.contiguous_format) if cuts else t
