"""The port's training path against the JAX package's, on the CPU.

Reduced qwen3-8b and h2o-danube-3-4b (2 layers, f32) on parameters
converted from the reference's ``init_params``: the loss and its
gradients for both attention implementations, one AdamW update, the LR
schedule, gradient compression and the synthetic batches.  Then the
port's own contracts: remat on ≡ off, 2 microbatches ≡ 1, two flash
launches per layer per step under remat, and copies of
``tests/test_system.py::TestTrainLoop`` (loss decreases, the VPE trials
and decides, fault recovery, deterministic restore, VPE state in the
checkpoint, compression trains), the checkpoint format (bf16 round trip,
reading the reference's checkpoints) and the launcher.

Tolerances: f32 sums in another order.  Losses agree within 1e-5
(worst observed 1e-6) and gradients within 1e-5 (worst observed 1.5e-6).
"""

import dataclasses
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import VPE  # noqa: E402
from repro_torch.core import state as tstate  # noqa: E402
from repro_torch.data import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.distributed.straggler import StepWatchdog  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw, compression, schedule  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402
from repro_torch.runtime.fault import SimulatedFault, run_with_recovery  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
IMPLS = {"reference": "reference", "flash_cuda": "flash_pallas"}   # port -> JAX


@pytest.fixture(scope="module", params=["qwen3-8b", "h2o-danube-3-4b"])
def arch(request):
    cfg = ARCHS[request.param].reduced()
    tcfg = get_config(request.param).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    return cfg, tcfg, jp, batch


def _port_params(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _loss_and_grads(tcfg, params, batch):
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = tmodel.loss_fn(tcfg, torch.utils._pytree.tree_unflatten(leaves, spec),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), torch.utils._pytree.tree_unflatten(list(grads), spec)


def _assert_tree_close(got, want, **tol):
    for (path, w) in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.detach().float().numpy(),
                                   np.asarray(w, np.float32), err_msg=str(path), **tol)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_loss_and_grads_match_reference(arch, impl):
    cfg, tcfg, jp, batch = arch
    jcfg = dataclasses.replace(cfg, attn_impl=IMPLS[impl])
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss_fn(
        jcfg, p, jax.tree.map(jnp.asarray, batch)))(jp)
    loss, grads = _loss_and_grads(dataclasses.replace(tcfg, attn_impl=impl),
                                  _port_params(jp), batch)
    assert loss == pytest.approx(float(jloss), rel=TOL["rtol"], abs=TOL["atol"])
    _assert_tree_close(grads, jgrads, **TOL)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_remat_on_equals_off(arch, impl):
    """Non-reentrant checkpointing around each layer, with the flash
    variant's backward running its own autograd inside the recomputation."""
    cfg, tcfg, jp, batch = arch
    out = {}
    for remat in ("full", "none"):
        c = dataclasses.replace(tcfg, attn_impl=impl, remat=remat)
        out[remat] = _loss_and_grads(c, _port_params(jp), batch)
    assert out["full"][0] == pytest.approx(out["none"][0], rel=1e-6)
    for a, b in zip(torch.utils._pytree.tree_leaves(out["full"][1]),
                    torch.utils._pytree.tree_leaves(out["none"][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat,per_layer", [("full", 2), ("none", 1)])
def test_flash_launches_per_step(arch, monkeypatch, remat, per_layer):
    """The flash variant calls the kernel wrapper once per layer in the
    forward and once more in each layer's recomputation under remat: the
    count the card run asserts (48 per step for full h2o-danube-3-4b)."""
    cfg, tcfg, jp, batch = arch
    calls = []
    real = tfa.flash_attention_cuda

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_cuda", counting)
    c = dataclasses.replace(tcfg, remat=remat)
    step = ttrain.make_train_step(c, adamw.AdamWConfig(), impl={"attn_impl": "flash_cuda"})
    params = _port_params(jp)
    step(params, ttrain.init_opt_state(adamw.AdamWConfig(), params),
         {k: torch.from_numpy(v) for k, v in batch.items()}, 1e-3)
    assert len(calls) == per_layer * c.num_layers


def test_microbatches_match_one_batch(arch):
    """2 microbatches accumulate f32 grads and divide by the count: the
    same loss, grad norm and first moment (0.1 x the clipped grads) as one
    pass over the whole batch — the mean loss over equal halves.  The
    moments are compared within 1e-6 of their largest value: a grad near
    zero has only an absolute error to compare."""
    cfg, tcfg, jp, batch = arch
    out = []
    for nmb in (1, 2):
        params = _port_params(jp)
        opt = ttrain.init_opt_state(adamw.AdamWConfig(), params)
        step = ttrain.make_train_step(tcfg, adamw.AdamWConfig(), num_microbatches=nmb)
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in batch.items()}, 1e-3)
        out.append((opt["m"], m))
    assert float(out[0][1]["loss"]) == pytest.approx(float(out[1][1]["loss"]), rel=1e-5)
    assert float(out[0][1]["grad_norm"]) == pytest.approx(
        float(out[1][1]["grad_norm"]), rel=1e-5)
    for a, b in zip(torch.utils._pytree.tree_leaves(out[0][0]),
                    torch.utils._pytree.tree_leaves(out[1][0])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


# -- optimizer, schedule, compression, data ------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(monkeypatch, dtype):
    """Two updates (bias corrections of steps 1 and 2), with the clip
    active; the port updates in slices (PIECE made small to cover them)."""
    monkeypatch.setattr(adamw, "PIECE", 16)
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 8), "layers": {"w": (3, 5, 7), "b": (3, 5)}, "s": (6,)}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: (2 * rng.standard_normal(s)).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple)) for _ in range(2)]
    cfg = jadamw.AdamWConfig(lr=1e-2, grad_clip=1.0)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
    jstate = jadamw.init(cfg, jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tstate = adamw.init(adamw.AdamWConfig(**dataclasses.asdict(cfg)), tp)
    assert ("master" in tstate) == ("master" in jstate) == (dtype == "bfloat16")
    for g in grads:
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), g)
        jp, jstate = jadamw.update(cfg, jg, jstate, jp, lr=3e-3)
        tg = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
        tp, tstate = adamw.update(adamw.AdamWConfig(**dataclasses.asdict(cfg)), tg,
                                  tstate, tp, lr=3e-3)
        np.testing.assert_allclose(float(adamw.global_norm(tg)),
                                   float(jadamw.global_norm(jg)), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    for key in ("m", "v") + (("master",) if dtype == "bfloat16" else ()):
        _assert_tree_close(tstate[key], jstate[key], rtol=1e-6, atol=1e-7)
    # bf16 params: the same f32 master rounds to the same bf16 value
    _assert_tree_close(tp, jp, rtol=1e-6, atol=1e-7)


def test_schedule_matches_reference():
    kw = dict(peak_lr=3e-4, warmup_steps=4, total_steps=20)
    for step in range(25):
        assert schedule.warmup_cosine(step, **kw) == pytest.approx(
            float(jschedule.warmup_cosine(step, **kw)), rel=1e-6)
        assert schedule.constant(step, peak_lr=0.1) == pytest.approx(
            float(jschedule.constant(step, peak_lr=0.1)), rel=1e-6)


def test_compression_matches_reference():
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((5, 70)).astype(np.float32),
         "b": np.zeros((3,), np.float32)}
    e = {"a": 0.01 * rng.standard_normal((5, 70)).astype(np.float32),
         "b": np.ones((3,), np.float32)}
    q, s = compression.quantize(torch.from_numpy(g["a"]), block=64)
    jq, js = jcomp.quantize(jnp.asarray(g["a"]), block=64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    comp, res = compression.ErrorFeedback.apply(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in e.items()}, block=64)
    jcomp_, jres = jcomp.ErrorFeedback.apply(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e), block=64)
    _assert_tree_close(comp, jcomp_, rtol=1e-6, atol=1e-7)
    _assert_tree_close(res, jres, rtol=1e-6, atol=1e-7)


def test_synthetic_batches_identical():
    cfg = dict(vocab_size=512, seq_len=16, global_batch=4, seed=7)
    ours, theirs = SyntheticStream(DataConfig(**cfg)), JStream(JDataConfig(**cfg))
    for step in (0, 1, 5):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    assert next(ours)["tokens"].shape == (4, 16) and ours.state_dict() == {"step": 1}


# -- the loop (copies of tests/test_system.py::TestTrainLoop) ------------------------

def make_loop(tmp, *, steps=8, family_arch="qwen3-8b", **kw):
    cfg = get_config(family_arch).reduced()
    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                      global_batch=4))
    lc = ttrain.TrainLoopConfig(total_steps=steps, checkpoint_every=2,
                                checkpoint_dir=tmp, log_every=0,
                                num_microbatches=kw.pop("num_microbatches", 2),
                                watchdog=kw.pop("watchdog", False), **kw)
    return ttrain.TrainLoop(cfg, lc, data, device="cpu")


class TestTrainLoop:
    def test_loss_decreases(self):
        with tempfile.TemporaryDirectory() as d:
            metrics = make_loop(d, steps=10).run()
            assert metrics[-1]["loss"] < metrics[0]["loss"]

    def test_vpe_trials_and_decides(self):
        """The loop trials flash_cuda against the reference attention and
        settles on a measured winner (the paper loop)."""
        with tempfile.TemporaryDirectory() as d:
            loop = make_loop(d, steps=14)
            loop.run()
            d_attn = loop.vpe.controller.decision("attn_impl", ("static",))
            assert "flash_cuda" in d_attn.tried
            events = [e for e, _, _ in d_attn.history]
            assert "trial" in events
            assert ("switch" in events) or ("revert" in events)

    def test_trial_steps_run_the_candidate(self, monkeypatch):
        """Each step runs the implementation the controller selects for it,
        trial steps included: the flash wrapper runs exactly on the steps
        booked to flash_cuda.  (The reference's loop rebinds only when the
        controller's version moves, which a trial's start does not do.)"""
        calls = []
        real = tfa.flash_attention_cuda
        monkeypatch.setattr(tfa, "flash_attention_cuda",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        with tempfile.TemporaryDirectory() as d:
            loop = make_loop(d, steps=9)
            booked = []
            while loop.step < 9:
                booked.append(loop.tuner.current()["attn_impl"])
                before = len(calls)
                loop.run(loop.step + 1)
                assert (len(calls) > before) == (booked[-1] == "flash_cuda")
            assert booked[:4] == ["reference"] * 4 and booked[4:7] == ["flash_cuda"] * 3

    def test_fault_recovery_resumes(self):
        with tempfile.TemporaryDirectory() as d:
            loop = make_loop(d, steps=8)
            fired = []

            def hook(step):
                if step == 5 and not fired:
                    fired.append(1)
                    raise SimulatedFault("device loss")

            loop.fault_hook = hook
            assert run_with_recovery(loop, 8) == 1
            assert loop.step == 8

    def test_restore_is_deterministic(self):
        """Same data cursor + params after restore -> same next loss."""
        with tempfile.TemporaryDirectory() as d:
            loop = make_loop(d, steps=4)
            loop.run()
            loop.save()
            loss_next = loop.run_step(loop.data.batch_at(loop.step))["loss"]
            loop2 = make_loop(d, steps=4)
            assert loop2.restore()
            assert loop2.step == 4
            loss_next2 = loop2.run_step(loop2.data.batch_at(loop2.step))["loss"]
            assert loss_next == pytest.approx(loss_next2, rel=1e-5)

    def test_grad_compression_trains(self):
        """The port's own result (the reference's copy of this test fails
        in its last tier-1 run; ROADMAP queue 3)."""
        with tempfile.TemporaryDirectory() as d:
            metrics = make_loop(d, steps=8, compress_grads=True).run()
            assert metrics[-1]["loss"] < metrics[0]["loss"]

    def test_vpe_state_survives_checkpoint(self):
        with tempfile.TemporaryDirectory() as d:
            loop = make_loop(d, steps=14)
            loop.run()
            loop.save()
            decisions = loop.vpe.controller.decision("attn_impl", ("static",)).tried
            loop2 = make_loop(d, steps=14)
            assert loop2.restore()
            assert loop2.vpe.controller.decision("attn_impl", ("static",)).tried == decisions

    def test_vpe_state_json_round_trip(self):
        """core.state: the loop's decisions survive dumps/loads and a file,
        and summarise as the reference summarises them."""
        with tempfile.TemporaryDirectory() as d:
            loop = make_loop(d, steps=8)
            loop.run()
            vpe2 = VPE(loop.vpe.registry)
            tstate.loads(vpe2, tstate.dumps(loop.vpe))
            assert vpe2.state_dict() == loop.vpe.state_dict()
            path = f"{d}/vpe.json"
            tstate.save(loop.vpe, path)
            vpe3 = VPE(loop.vpe.registry)
            tstate.load(vpe3, path)
            assert tstate.dumps(vpe3) == tstate.dumps(loop.vpe)
            summary = tstate.summary(loop.vpe.state_dict())
            assert summary == jstate.summary(loop.vpe.state_dict())
            assert summary.startswith("attn_impl ('static',): ")

    def test_late_step_is_kept_then_restores(self):
        """A step that trips the watchdog completed in place and is kept; a
        second late step in a row rewinds to the checkpoint."""
        with tempfile.TemporaryDirectory() as d:
            loop = make_loop(d, steps=6, watchdog=True)
            now = [0.0]
            late = {3, 4}          # each of these steps is late once

            def fence(value):
                if loop.step in late:
                    late.discard(loop.step)
                    now[0] += 100.0
                else:
                    now[0] += 1.0
                return value

            loop.watchdog = StepWatchdog(clock=lambda: now[0], fence=fence,
                                         min_budget_s=0.0)
            # step 3 is late and kept; step 4 is late too, so the loop
            # rewinds to the checkpoint of step 4 and runs that step again
            loop.run(6)
            assert loop.watchdog.trips == 2 and loop.step == 6
            lc = loop.loop_cfg
            assert [m["lr"] for m in loop.metrics_log] == [
                schedule.warmup_cosine(s, peak_lr=lc.peak_lr, total_steps=lc.total_steps,
                                       warmup_steps=lc.warmup_steps)
                for s in (0, 1, 2, 3, 4, 4, 5)]


# -- checkpoint format, launcher ------------------------------------------------------

def test_bf16_checkpoint_round_trip():
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((3, 5), generator=gen).to(torch.bfloat16),
            "s": {"m": torch.randn((4,), generator=gen), "n": torch.tensor(7, dtype=torch.int32)}}
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 3, tree, extra={"x": 1})
        like = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
                "s": {"m": torch.zeros(4), "n": torch.tensor(0, dtype=torch.int32)}}
        got, extra, step = tckpt.restore(d, like)
        assert got is like and extra == {"x": 1} and step == 3
        for a, b in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        with pytest.raises(TypeError):
            tckpt.restore(d, {**like, "w": torch.zeros((3, 5))})


def test_restores_a_reference_checkpoint():
    """The layout is the reference's: the port reads a checkpoint the JAX
    package wrote, bf16 leaves bit for bit."""
    rng = np.random.default_rng(5)
    tree = {"p": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
            "opt": {"step": jnp.asarray(3, jnp.int32),
                    "m": jnp.asarray(rng.standard_normal((6,)), jnp.float32)}}
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 9, tree)
        like = {"p": torch.zeros((4, 6), dtype=torch.bfloat16),
                "opt": {"step": torch.tensor(0, dtype=torch.int32),
                        "m": torch.zeros(6)}}
        got, _, step = tckpt.restore(d, like)
    assert step == 9
    _assert_tree_close(got, tree, rtol=0, atol=0)


def test_launcher_smoke_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        tlaunch.main(["--arch", "h2o-danube-3-4b", "--smoke", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--ckpt", d])
        assert tckpt.latest_step(d) == 3
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "attn_impl" in out
