"""Faults planted under the timed path make ``correct`` false: the rest of
a run is driven at a smoke size on the CPU (no look for a card), with the
program broken underneath.  Serving: a token altered where it is produced.
Training: a step that returns its state unchanged, and half of each batch
left out with the mean taken over the rest.  One chip cells only: there is
no exchange between chips to leave out."""

import time

import pytest

from portbench import harness


def _run(spec, cell, fault=None, seed=5, seconds=1.5):
    return harness.run_cell(cell, seed, seconds, False, t0=time.perf_counter(),
                            device="cpu", spec=spec, fault=fault)


def _alter_tokens(engine):
    """Every decode call's tokens come out one id higher than computed."""
    launch = engine.graphs.launch
    vocab = engine.cfg.vocab_size

    def altered(impl, H, *a, **k):
        out, captured = launch(impl, H, *a, **k)
        out = out.clone()
        out[0] = (out[0] + 1) % vocab
        return out, captured

    engine.graphs.launch = altered


@pytest.mark.parametrize("cell", ["qwen3-8b.chat-decode", "qwen3-8b.shared-prefix"])
def test_serving_sound_and_with_a_token_altered(small, cell):
    spec = small(cell)
    assert _run(spec, cell)["correct"] is True
    r = _run(spec, cell, fault=_alter_tokens)
    assert r["correct"] is False
    assert r["checks"]["widest_logit_gap"]["value"] > r["checks"]["widest_logit_gap"]["limit"]


CELL = "h2o-danube-3-4b.train-4k"


def test_training_sound(small):
    assert _run(small(CELL), CELL)["correct"] is True


def test_training_state_left_unchanged(small, monkeypatch):
    from repro_torch.runtime import train_loop
    monkeypatch.setattr(train_loop.adamw, "update",
                        lambda cfg, grads, state, params, lr=None, gnorm=None: (params, state))
    r = _run(small(CELL), CELL)
    assert r["correct"] is False
    assert r["checks"]["first_grad_gap"]["value"] == pytest.approx(1.0)
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_half_of_the_batch_left_out(small):
    def halve(loop):
        prepare = loop.prepare

        def half(batch):
            placed = prepare(batch)
            return {k: v[:, : v.shape[1] // 2] for k, v in placed.items()}

        loop.prepare = half

    r = _run(small(CELL), CELL, fault=halve)
    assert r["correct"] is False
    bad = [n for n, c in r["checks"].items() if c["value"] > c["limit"]]
    assert bad


@pytest.mark.parametrize("cell", ["qwen3-8b.chat-decode", "qwen3-8b.shared-prefix"])
def test_serving_control_reads_wider_than_the_program(small, cell):
    """The control (the reference in fp8 in the program's place) is judged
    by the cell's limit and comes out not correct; the f32 program's own gap
    on the same sample, reported beside it, passes.  The cells' limits are
    set at their own sizes on the card; at this smoke size the program read
    0-0.006 and the control 0.13-0.77 over seeds 11-16, so the limit here
    is 0.05."""
    spec = small(cell)
    spec.cell = {**spec.cell, "limits": {"widest_logit_gap": 0.05}}
    r = harness.run_cell(cell, 11, 2.0, False, t0=time.perf_counter(), device="cpu",
                         spec=spec, control=True)
    c = r["checks"]
    assert r["correct"] is False
    assert c["widest_logit_gap"]["value"] > c["widest_logit_gap"]["limit"]
    assert c["program_widest_logit_gap"]["value"] <= c["widest_logit_gap"]["limit"]
    assert c["widest_logit_gap"]["value"] > 3 * c["program_widest_logit_gap"]["value"]


def test_training_control_reads_wider_than_the_program(small):
    """The fp8 reference in the program's place fails the cell's limits; the
    program's own numbers pass them."""
    r = harness.run_cell(CELL, 11, 1.0, False, t0=time.perf_counter(), device="cpu",
                         spec=small(CELL), control=True)
    c = r["checks"]
    assert r["correct"] is False
    assert all(c[f"program_{k}"]["value"] <= c[f"program_{k}"]["limit"]
               for k in ("loss_gap", "first_grad_gap", "change_gap"))
    assert any(c[k]["value"] > c[k]["limit"] for k in ("loss_gap", "first_grad_gap"))
    for k in ("loss_gap", "first_grad_gap"):
        assert c[k]["value"] > 3 * c[f"program_{k}"]["value"]


@pytest.mark.cuda
def test_small_cells_on_the_card(small, cuda_device):
    """The smoke-size cells through the card's kernels in bf16: the check
    passes; with the fp8 control in the program's place the training check
    fails, and the serving control reads wider than the program (the
    serving limit is set at the cell's own size)."""
    for cell in ("qwen3-8b.chat-decode", CELL):
        spec = small(cell)
        spec.config = {**spec.config, "torch_dtype": "bfloat16", "head_dim": 128,
                       "hidden_size": 256, "num_attention_heads": 8}
        r = harness.run_cell(cell, 13, 2.0, True, t0=time.perf_counter(), device="cuda",
                             spec=spec)
        assert r["correct"] is True, r["checks"]
        assert r["device"]["busy_s"] > 0
        r = harness.run_cell(cell, 13, 2.0, False, t0=time.perf_counter(), device="cuda",
                             spec=spec, control=True)
        c = r["checks"]
        if cell == CELL:
            assert r["correct"] is False, c
        else:
            assert c["widest_logit_gap"]["value"] > c["program_widest_logit_gap"]["value"], c
