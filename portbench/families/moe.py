"""The moe family: the dense family's decoder with every layer's SwiGLU FFN
replaced by a mixture of experts, as the port's ``models/moe.py`` has it:

* an f32 router (``d_model`` x ``num_experts``) and a softmax over all
  experts;
* each token's top ``num_experts_per_tok`` experts, their gates renormalised
  over the k where ``norm_topk_prob``;
* SwiGLU experts of width ``moe_intermediate_size``;
* the shared experts as one SwiGLU of width ``num_shared_experts *
  moe_intermediate_size`` (n SwiGLUs of one width, summed, are one of n
  times it), added to the routed sum;
* the leaves under the port's ``layers/moe_*`` names, the router in f32.

HF key names: ``num_experts`` (or ``n_routed_experts``,
``num_local_experts``), ``num_experts_per_tok``, ``moe_intermediate_size``,
``norm_topk_prob``, and for the shared experts ``num_shared_experts`` (or
``n_shared_experts``) or ``shared_expert_intermediate_size``, a whole
multiple of the expert width.  The rest is the dense family's.

``port.capacity_factor`` is required.  The port drops an assignment past
its expert's capacity, ``capacity_factor * rows * k / num_experts`` of the
rows routed together; published models, and the reference
(``reference/moe.py``), drop none.  At ``capacity_factor * k >=
num_experts`` the capacity holds every row, so nothing drops.

Where the port departs from published MoE models:

* Qwen1.5-MoE and Qwen2-MoE gate the shared expert's output by a per-token
  sigmoid (``shared_expert_gate``, a weight with no key in config.json);
  the port adds the shared SwiGLU ungated, and so does the reference;
* the port always renormalises the top-k gates: a file stating
  ``norm_topk_prob`` false (Qwen1.5-MoE's) is refused by :func:`port_config`;
* routing other than a softmax top-k (DeepSeek's sigmoid scores,
  group-limited ``noaux_tc`` top-k with a correction bias, a routed scaling
  factor, an expert bias), leading dense layers or a period of MoE layers,
  and a window that differs between layers are not in the port: a file
  that states one is refused by :func:`dims`;
* attention biases, as in the dense family, are in no configuration here.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, List, Optional

from portbench.families import dense
from portbench.weights import Spec

# keys of published MoE configurations, and the values of each that the
# port runs; a file stating another value is refused
PLAIN = {
    "scoring_func": ("softmax",),
    "topk_method": ("greedy",),
    "n_group": (None, 1),
    "topk_group": (None, 1),
    "routed_scaling_factor": (None, 1.0),
    "moe_routed_scaling_factor": (None, 1.0),
    "use_expert_bias": (False,),
    "first_k_dense_replace": (0,),
    "decoder_sparse_step": (1,),
    "moe_layer_freq": (1,),
    "mlp_only_layers": ([],),
}


@dataclasses.dataclass(frozen=True)
class Dims(dense.Dims):
    """The dense family's sizes, ``d_ff`` the shared experts' width (the
    port's ``ModelConfig.d_ff`` of an MoE), and the experts'."""
    family: ClassVar[str] = "moe"
    num_experts: int
    top_k: int
    moe_d_ff: int
    num_shared_experts: int
    norm_topk_prob: bool

    def param_count(self) -> int:
        d, e, f = self.d_model, self.num_experts, self.moe_d_ff
        layer = 2 * d + dense.attention_params(self) + (2 * self.head_dim if self.qk_norm else 0)
        layer += d * e + 3 * e * d * f + 3 * d * self.d_ff
        head = 0 if self.tie_embeddings else d * self.vocab_size
        return self.num_layers * layer + self.vocab_size * d + d + head


def _one_of(conf: Dict, *keys: str):
    for k in keys:
        if conf.get(k) is not None:
            return conf[k]
    raise KeyError(f"{conf.get('name')}: none of {keys} in the configuration file")


def dims(conf: Dict) -> Dims:
    bad = {k: conf[k] for k, ok in PLAIN.items() if k in conf and conf[k] not in ok}
    if len(set(conf.get("layer_types") or [])) > 1:
        bad["layer_types"] = sorted(set(conf["layer_types"]))
    if bad:
        raise ValueError(f"{conf.get('name')}: the moe family runs a softmax top-k router "
                         f"in every layer under one window; the file states {bad}")
    f = int(conf["moe_intermediate_size"])
    if conf.get("num_shared_experts") is not None or conf.get("n_shared_experts") is not None:
        shared = int(_one_of(conf, "num_shared_experts", "n_shared_experts"))
    else:
        width = int(conf.get("shared_expert_intermediate_size") or 0)
        if width % f:
            raise ValueError(f"{conf.get('name')}: shared_expert_intermediate_size {width} "
                             f"is no whole number of experts of width {f}")
        shared = width // f
    base = dense.dims({**conf, "intermediate_size": shared * f})
    return Dims(**dataclasses.asdict(base),
                num_experts=int(_one_of(conf, "num_experts", "n_routed_experts",
                                        "num_local_experts")),
                top_k=int(conf["num_experts_per_tok"]), moe_d_ff=f,
                num_shared_experts=shared, norm_topk_prob=bool(conf["norm_topk_prob"]))


def port_config(conf: Dict, d: Optional[Dims] = None):
    """The port's ``ModelConfig``: the dense family's, with the experts and
    the ``port.capacity_factor`` pin."""
    d = d or dims(conf)
    if not d.norm_topk_prob:
        raise ValueError(f"{d.name}: the port renormalises the top-k gates always; "
                         f"the file states norm_topk_prob false")
    cf = float(conf["port"]["capacity_factor"])
    if cf * d.top_k < d.num_experts:
        raise ValueError(f"{d.name}: port.capacity_factor {cf} drops assignments; "
                         f"a dropless run needs at least num_experts / top_k = "
                         f"{d.num_experts / d.top_k}")
    return dataclasses.replace(
        dense.port_config(conf, d), num_experts=d.num_experts,
        num_shared_experts=d.num_shared_experts, top_k=d.top_k, moe_d_ff=d.moe_d_ff,
        capacity_factor=cf)


def leaf_specs(d: Dims) -> List[Spec]:
    """The dense family's leaves without its FFN, and the MoE block's."""
    L, dm, e, f, fs = d.num_layers, d.d_model, d.num_experts, d.moe_d_ff, d.d_ff
    specs = [s for s in dense.leaf_specs(d) if not s[0].startswith("layers/ffn_")]
    specs += [("layers/moe_router", (L, dm, e), "normal", "float32"),
              ("layers/moe_experts_gate", (L, e, dm, f), "normal", None),
              ("layers/moe_experts_up", (L, e, dm, f), "normal", None),
              ("layers/moe_experts_down", (L, e, f, dm), "normal", None)]
    if d.num_shared_experts:
        specs += [("layers/moe_shared_w_gate", (L, dm, fs), "normal", None),
                  ("layers/moe_shared_w_up", (L, dm, fs), "normal", None),
                  ("layers/moe_shared_w_down", (L, fs, dm), "normal", None)]
    return specs


def layer_matmul_params(d: Dims) -> int:
    """Weights one token multiplies in one layer: the attention projections,
    the router, its k experts' SwiGLUs and the shared SwiGLU."""
    ffn = d.d_model * d.num_experts + 3 * d.top_k * d.d_model * d.moe_d_ff
    return dense.attention_params(d) + ffn + 3 * d.d_model * d.d_ff


def token_flops(d: Dims, context: int, logits: bool) -> int:
    return dense.decoder_token_flops(d, layer_matmul_params(d), context, logits)
