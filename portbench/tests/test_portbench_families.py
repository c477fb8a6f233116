"""The family seam (``portbench/families/``, ``portbench/reference/``).

The dense family reads, bit for bit, what the harness read before it moved
behind the seam: every leaf of ``make_params`` (order and bits) and every
output of the plain reference, at a smoke size on the CPU.  The recorded
values in ``dense_bits.json`` came from :func:`weight_readings` and
:func:`reference_readings` run on the harness before the move, with that
harness's functions passed in; they are of float32 kernels on an x86-64 CPU
with AVX-512 in one thread, and another instruction set may round
otherwise.

The ``moe`` family, added by its two files alone, serves a smoke cell
through the unchanged serving driver with ``correct`` true, and a routing
fault planted in the engine reads ``correct`` false.
"""

import dataclasses
import hashlib
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness

HERE = Path(__file__).resolve().parent
BITS = HERE / "dense_bits.json"
CONFIGS = ("qwen3-8b", "h2o-danube-3-4b")
SEEDS = (7, 2718281829)
SCHEDULE = {"peak_lr": 3e-4, "warmup_steps": 1, "total_steps": 100}


def digest(t: torch.Tensor) -> str:
    """The first 20 hex digits of the sha256 of a tensor's bytes."""
    raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:20]


def small_conf(name: str, **over) -> dict:
    from conftest import SMALL
    conf = harness.load_json(harness.ROOT / "portbench" / "configs" / f"{name}.json")
    return {**conf, **SMALL, **over}


def _flat(tree: dict) -> dict:
    """``{"layers": {"b": u}}`` -> ``{"layers/b": u}``, in the tree's order."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{k2}": v2 for k2, v2 in v.items()})
        else:
            flat[k] = v
    return flat


class _OneThread:
    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


def weight_readings(dims, make_params) -> dict:
    """Per configuration, seed and dtype: each leaf's path and digest, in
    ``make_params``'s order."""
    out = {}
    for name in CONFIGS:
        d = dims(small_conf(name))
        for seed in SEEDS:
            for dt in ("float32", "bfloat16"):
                flat = _flat(make_params(d, seed, torch.device("cpu"), getattr(torch, dt)))
                out[f"{name}/{seed}/{dt}"] = [[k, digest(v)] for k, v in flat.items()]
    return out


def reference_readings(dims, make_params, serve_logits, loss, train) -> dict:
    """Serving logits (f32 and fp8), the loss and its gradients (with and
    without remat) and three AdamW steps (f32, fp8, half rows) of the dense
    reference at a smoke size, as digests and exact float hex."""
    out = {}
    cases = {name: small_conf(name) for name in CONFIGS}
    cases["h2o-danube-3-4b/window-8"] = small_conf("h2o-danube-3-4b", sliding_window=8)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 512, 40).astype(np.int64))
    rows = [torch.from_numpy(rng.integers(0, 512, (2, 24)).astype(np.int64))
            for _ in range(6)]
    opt = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    with _OneThread():
        for case, conf in cases.items():
            d = dims(conf)
            flat = _flat(make_params(d, 7, torch.device("cpu"), torch.float32))
            r = {}
            for p in ("f32", "fp8"):
                r[f"serve_logits/{p}"] = digest(serve_logits(d, flat, toks, 10, p))
            for remat in (True, False):
                leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
                lval = loss(d, leaves, rows[0], rows[1], "f32", remat)
                grads = torch.autograd.grad(lval, list(leaves.values()))
                r[f"loss/remat={remat}"] = float(lval.detach()).hex()
                r[f"grads/remat={remat}"] = [digest(g) for g in grads]
            for variant, kw in (("f32", {}), ("fp8", {"precision": "fp8"}),
                                ("half_rows", {"half_rows": True})):
                params = {k: v.clone() for k, v in flat.items()}
                batches = [(rows[0], rows[1]), (rows[2], rows[3]), (rows[4], rows[5])]
                got = train(d, params, batches, opt, SCHEDULE, **kw)
                r[f"train/{variant}"] = {
                    "loss": [x.hex() for x in got["loss"]],
                    "grad_norm": [x.hex() for x in got["grad_norm"]],
                    "first_grad_norms": {k: x.hex() for k, x in got["first_grad_norms"].items()},
                    "params": {k: digest(v) for k, v in params.items()},
                }
            out[case] = r
    return out


def _dense():
    from portbench import families, weights
    from portbench.reference import common, dense
    fam = families.program("dense")

    def train(d, params, batches, opt, schedule, **kw):
        return common.train(dense.loss, d, params, batches, opt, schedule, **kw)

    return fam.dims, weights.make_params, dense.serve_logits, dense.loss, train


def test_dense_weights_bit_for_bit():
    dims, make_params, *_ = _dense()
    want = json.loads(BITS.read_text())["weights"]
    got = weight_readings(dims, make_params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert [p for p, _ in got[key]] == [p for p, _ in want[key]], key   # leaf order
        assert got[key] == want[key], key


def test_dense_reference_bit_for_bit():
    want = json.loads(BITS.read_text())["reference"]
    got = reference_readings(*_dense())
    assert sorted(got) == sorted(want)
    for case in want:
        for k in want[case]:
            assert got[case][k] == want[case][k], (case, k)


MOE = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
           num_shared_experts=2, norm_topk_prob=True)


def moe_conf(**over) -> dict:
    """qwen3-8b's file at the smoke size with the MoE keys, ``port.family``
    moe and a capacity at which nothing drops (8 experts / top 2)."""
    conf = small_conf("qwen3-8b", **{**MOE, **over})
    conf["port"] = {**conf["port"], "family": "moe", "capacity_factor": 4.0}
    return conf


def test_moe_leaves_are_the_ports_layout():
    from portbench import families, weights
    from repro_torch.models import transformer
    fam = families.program("moe")
    conf = moe_conf()
    d = fam.dims(conf)
    cfg = fam.port_config(conf, d)
    assert (cfg.family, cfg.num_experts, cfg.top_k, cfg.moe_d_ff, cfg.num_shared_experts,
            cfg.capacity_factor, cfg.d_ff) == ("moe", 8, 2, 64, 2, 4.0, 128)
    shapes = weights.flatten(transformer.param_shapes(cfg))
    specs = {p: (tuple(s), dt) for p, s, _, dt in weights.leaf_specs(d)}
    assert {p: s for p, (s, _) in specs.items()} == {p: tuple(s) for p, s in shapes.items()}
    port = transformer.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                                   torch.Generator().manual_seed(0))
    tree = weights.make_params(d, 3, torch.device("cpu"), torch.bfloat16)
    for p, leaf in weights.flatten(tree).items():
        assert leaf.dtype == weights.flatten(port)[p].dtype, p   # the router f32
    assert specs["layers/moe_router"][1] == "float32"
    assert d.param_count() == sum(int(np.prod(s)) for s, _ in specs.values())


@pytest.mark.parametrize("shared", [0, 2])
def test_moe_reference_matches_port_forward(shared):
    from portbench import families, weights
    from portbench.reference import moe as ref
    from repro_torch.models import model as model_lib
    fam = families.program("moe")
    conf = moe_conf(num_shared_experts=shared)
    d = fam.dims(conf)
    params = weights.make_params(d, 5, torch.device("cpu"), torch.float32)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, 40).astype(np.int64))
    want = model_lib.forward(fam.port_config(conf, d), params, {"tokens": toks[None]})[0]
    got = ref.serve_logits(d, weights.flatten(params), toks, 10)
    torch.testing.assert_close(got, want[10:], rtol=1e-4, atol=1e-4)


def test_moe_refuses_what_the_port_does_not_run():
    from portbench import families
    fam = families.program("moe")
    with pytest.raises(ValueError, match="norm_topk_prob"):
        fam.port_config(moe_conf(norm_topk_prob=False))
    conf = moe_conf()
    conf["port"]["capacity_factor"] = 1.25
    with pytest.raises(ValueError, match="drops"):
        fam.port_config(conf)
    with pytest.raises(ValueError, match="scoring_func"):
        fam.dims(moe_conf(scoring_func="sigmoid"))
    with pytest.raises(ValueError, match="layer_types"):
        fam.dims(moe_conf(layer_types=["sliding_attention", "full_attention"]))
    shared = {k: v for k, v in moe_conf().items() if k != "num_shared_experts"}
    assert fam.dims({**shared, "shared_expert_intermediate_size": 192}).num_shared_experts == 3
    with pytest.raises(ValueError, match="whole number"):
        fam.dims({**shared, "shared_expert_intermediate_size": 100})


def _moe_spec(small):
    spec = small("qwen3-8b.chat-decode")
    spec.config = moe_conf()
    return spec


def _roll_router(engine):
    """Every layer's router columns rolled by one expert: each token goes
    to the experts next to its own."""
    leaves = engine.params["layers"]
    leaves["moe_router"] = torch.roll(leaves["moe_router"], 1, dims=-1)


def test_moe_serve_cell_is_correct(small):
    cell = "qwen3-8b.chat-decode"
    r = harness.run_cell(cell, 2718281831, 1.5, False, t0=time.perf_counter(), device="cpu",
                         spec=_moe_spec(small))
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["sampled_requests"]["value"] >= 2


def test_moe_routing_fault_is_not_correct(small):
    cell = "qwen3-8b.chat-decode"
    r = harness.run_cell(cell, 2718281831, 1.5, False, t0=time.perf_counter(), device="cpu",
                         spec=_moe_spec(small), fault=_roll_router)
    c = r["checks"]["widest_logit_gap"]
    assert r["correct"] is False and c["value"] > c["limit"], r["checks"]


def test_unknown_family_names_the_families_present():
    from portbench import families
    assert {"dense", "moe"} <= set(families.present())
    with pytest.raises(ValueError) as e:
        families.for_config({"port": {"family": "ssm"}})
    assert all(f in str(e.value) for f in families.present())


def test_a_family_without_a_loss_trains_nowhere(small):
    from portbench import check_train, families
    d = families.program("moe").dims(moe_conf())
    with pytest.raises(NotImplementedError, match="no loss"):
        check_train.family_loss(d)


def test_every_familys_reference_imports_nothing_of_the_program():
    """Each family has its reference file, and every file under
    ``reference/`` (each family's and the shared pieces) imports nothing of
    JAX, the JAX package or the program."""
    import ast
    from portbench import families
    ref = HERE.parent / "reference"
    files = sorted(ref.glob("*.py"))
    for f in families.present():
        assert ref / f"{f}.py" in files, f
    assert ref / "common.py" in files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "repro",
                                                "repro_torch"), (f, n)


@pytest.mark.cuda
def test_moe_cell_on_the_card(small, cuda_device):
    """The smoke MoE cell through the card's paged kernels and decode
    graphs, at the head size they are built for: correct; with the router
    rolled, not correct.  In f32: at bf16 a near tie of two gates can route
    a token otherwise than the f32 reference does, which the limit of a
    cell at its own size has to weigh."""
    spec = _moe_spec(small)
    spec.config = {**spec.config, "head_dim": 128, "hidden_size": 256,
                   "num_attention_heads": 8}
    cell = "qwen3-8b.chat-decode"
    r = harness.run_cell(cell, 2718281833, 2.0, True, t0=time.perf_counter(), device="cuda",
                         spec=spec)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["busy_s"] > 0
    r = harness.run_cell(cell, 2718281833, 2.0, False, t0=time.perf_counter(), device="cuda",
                         spec=spec, fault=_roll_router)
    assert r["correct"] is False, r["checks"]
