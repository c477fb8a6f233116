"""The plain reference against the port, at a smoke size on the CPU, in f32:
the serving logits after a prompt and served tokens, the training loss and
its gradients, and an AdamW step."""

import math

import numpy as np
import pytest
import torch


def _dims(qk_norm=True, window=None):
    from portbench.families.dense import Dims
    return Dims(name="small", num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                head_dim=32, d_ff=256, vocab_size=512, rope_theta=1e4, rms_eps=1e-6,
                qk_norm=qk_norm, qkv_bias=False, tie_embeddings=False, window=window,
                dtype="float32")


def _port_cfg(d, **kw):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name="small", family="dense", num_layers=d.num_layers,
                       d_model=d.d_model, num_heads=d.num_heads,
                       num_kv_heads=d.num_kv_heads, d_ff=d.d_ff, vocab_size=d.vocab_size,
                       head_dim=d.head_dim, qk_norm=d.qk_norm, window=d.window,
                       rope_theta=d.rope_theta, rms_eps=d.rms_eps, dtype="float32", **kw)


@pytest.mark.parametrize("qk_norm", [True, False])
def test_serve_logits_match_port_forward(qk_norm):
    from portbench import weights
    from portbench.reference import dense as ref
    from repro_torch.models import model as model_lib
    d = _dims(qk_norm=qk_norm)
    params = weights.make_params(d, 7, torch.device("cpu"), torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, 40).astype(np.int64))
    want = model_lib.forward(_port_cfg(d), params, {"tokens": toks[None]})[0]
    got = ref.serve_logits(d, weights.flatten(params), toks, 10)
    torch.testing.assert_close(got, want[10:], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [None, 8])
def test_loss_and_grads_match_port(window):
    from portbench import weights
    from portbench.reference import dense as ref
    from repro_torch.models import model as model_lib
    d = _dims(qk_norm=False, window=window)
    params = weights.make_params(d, 11, torch.device("cpu"), torch.float32)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 24)).astype(np.int64))
    labels = torch.from_numpy(rng.integers(0, 512, (2, 24)).astype(np.int64))
    flat = {k: v.clone().requires_grad_(True) for k, v in weights.flatten(params).items()}
    port = weights.nest(flat)
    lp = model_lib.loss_fn(_port_cfg(d, remat="none"), port,
                           {"tokens": toks, "labels": labels})
    gp = torch.autograd.grad(lp, list(flat.values()))
    flat2 = {k: v.detach().clone().requires_grad_(True) for k, v in flat.items()}
    lr_ = ref.loss(d, flat2, toks, labels)
    gr = torch.autograd.grad(lr_, list(flat2.values()))
    assert abs(float(lp.detach()) - float(lr_.detach())) < 1e-5
    for a, b in zip(gp, gr):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)


def test_adamw_step_matches_port():
    from portbench.reference import common as ref
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(3)
    p = {"a": torch.randn(5, 7, generator=gen), "b": torch.randn(9, generator=gen)}
    g = {k: torch.randn(v.shape, generator=gen) * 3 for k, v in p.items()}
    opt = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    cfg = adamw.AdamWConfig(**opt)
    port_p = {k: v.clone() for k, v in p.items()}
    state = adamw.init(cfg, port_p)
    ref_p = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    for step in (1, 2):
        gn = math.sqrt(sum(float(x.norm()) ** 2 for x in g.values()))
        adamw.update(cfg, g, state, port_p, lr=1e-2)
        ref.adamw_step(ref_p, dict(g), m, v, step, 1e-2, opt, min(1.0, 1.0 / (gn + 1e-9)),
                       piece=8)
    for k in p:
        torch.testing.assert_close(ref_p[k], port_p[k], rtol=1e-6, atol=1e-7)


def test_schedule_matches_port():
    from portbench.reference import common as ref
    from repro_torch.optim import schedule
    for s in (0, 1, 5, 10, 50, 100000):
        assert ref.warmup_cosine(s, 3e-4, 10, 1000) == schedule.warmup_cosine(
            s, peak_lr=3e-4, warmup_steps=10, total_steps=1000)


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib
    here = pathlib.Path(__file__).resolve().parents[1]
    for f in list((here / "reference").glob("*.py")) + [here / "weights.py",
                                                        here / "check_serve.py",
                                                        here / "check_train.py"]:
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "repro",
                                                "repro_torch"), (f, n)

