"""Port VPE core and configs against ``repro``: equal configs, equal
bucket keys, and the controller cases of tests/test_vpe_core.py."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import shape_class as jsc  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import VPE, Controller, Registry, shape_bucket  # noqa: E402
from repro_torch.core import shape_class as tsc  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(tconfigs.ARCHS))
def test_configs_are_copies(name):
    """Field for field equal to the reference, full and reduced, and the
    analytic parameter count agrees."""
    full, ref = tconfigs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert dataclasses.asdict(full.reduced()) == dataclasses.asdict(ref.reduced())
    assert full.param_count() == ref.param_count()
    assert full.reduced().param_count() == ref.reduced().param_count()


def test_get_config_unknown_raises():
    with pytest.raises(KeyError):
        tconfigs.get_config("qwen2-moe-a2.7b")


class TestBucketKeys:
    """Decision tables of the two packages must be comparable key by key."""

    @pytest.mark.parametrize("active,total,levels", [
        (0, 4, 4), (1, 4, 4), (2, 4, 4), (3, 4, 4), (4, 4, 4), (1, 2, 4),
        (5, 8, 3), (2, 0, 4)])
    def test_occupancy_bucket(self, active, total, levels):
        got = tsc.occupancy_bucket(active, total, levels=levels)
        assert got == jsc.occupancy_bucket(active, total, levels=levels)
        assert tsc.bucket_label(got) == jsc.bucket_label(got)

    @pytest.mark.parametrize("plen", [0, 1, 7, 16, 17, 500, 4096])
    @pytest.mark.parametrize("active", [0, 3])
    def test_prefill_chunk_bucket(self, plen, active):
        got = tsc.prefill_chunk_bucket(plen, active, 4)
        assert got == jsc.prefill_chunk_bucket(plen, active, 4)
        assert tsc.bucket_label(got) == jsc.bucket_label(got)
        p = tsc.prefix_len_bucket(plen)
        assert p == jsc.prefix_len_bucket(plen)
        assert tsc.bucket_label(p) == jsc.bucket_label(p)

    @pytest.mark.parametrize("n,minimum", [(1, 16), (16, 16), (17, 16),
                                           (100, 16), (3, 1), (1025, 16)])
    def test_pad_to_bucket(self, n, minimum):
        assert tsc.pad_to_bucket(n, minimum=minimum) == \
            jsc.pad_to_bucket(n, minimum=minimum)

    @pytest.mark.parametrize("shapes", [[(64, 64)], [(8, 8), (3,)],
                                        [(2, 3, 4), (5,)], [()], []])
    def test_shape_bucket(self, shapes):
        arrs = [np.ones(s, np.float32) for s in shapes]
        tens = [torch.ones(s) for s in shapes]
        got = tsc.shape_bucket(*tens)
        assert got == jsc.shape_bucket(*arrs)
        # nested containers flatten the same way
        assert tsc.shape_bucket({"a": tens}) == jsc.shape_bucket({"a": arrs})
        if got != ("scalar",):
            assert tsc.bucket_label(got) == jsc.bucket_label(got)


# -- controller / registry cases ported from tests/test_vpe_core.py ----------

def make_vpe(**ck):
    defaults = dict(min_samples=2, trial_samples=2, hysteresis=0.05)
    defaults.update(ck)
    vpe = VPE(controller_kwargs=defaults)
    clock = [0.0]
    vpe.profiler._clock = lambda: clock[0]
    return vpe, clock


X = torch.ones((64, 64))


def register_pair(vpe, clock, slow_s, fast_s, name="op"):
    @vpe.op(name)
    def ref(x):
        clock[0] += slow_s
        return x

    @vpe.variant(name, variant="accel")
    def accel(x):
        clock[0] += fast_s
        return x

    return ref


class TestController:
    def test_switches_to_faster_variant(self):
        vpe, clock = make_vpe()
        op = register_pair(vpe, clock, 0.010, 0.002)
        for _ in range(12):
            op(X)
        assert op.variant_for(X) == "accel"

    def test_reverts_slower_variant_without_version_bump(self):
        vpe, clock = make_vpe()
        op = register_pair(vpe, clock, 0.004, 0.012)
        v0 = vpe.controller.version
        for _ in range(12):
            op(X)
        d = vpe.controller.decision("op", shape_bucket(X))
        assert d.selected == "reference"
        assert ("revert", "accel") in [(e, v) for e, v, _ in d.history]
        assert vpe.controller.version == v0

    def test_hysteresis_blocks_marginal_win(self):
        vpe, clock = make_vpe(hysteresis=0.2)
        op = register_pair(vpe, clock, 0.010, 0.009)
        for _ in range(12):
            op(X)
        assert op.variant_for(X) == "reference"

    def test_warmup_excluded_from_steady_stats(self):
        vpe, clock = make_vpe()
        calls = {"n": 0}

        @vpe.op("warm")
        def op(x):
            calls["n"] += 1
            clock[0] += 1.0 if calls["n"] == 1 else 0.001
            return x

        for _ in range(5):
            op(X)
        ss = vpe.profiler.samples("warm", "reference", shape_bucket(X))
        assert ss.warmup.n == 1
        assert ss.steady.mean < 0.01

    def test_per_bucket_decisions(self):
        """Fig. 2b: small inputs keep the naive variant, large move."""
        vpe, clock = make_vpe()

        @vpe.op("mm")
        def mm(x):
            clock[0] += 1e-9 * x.numel()
            return x

        @vpe.variant("mm", variant="dsp")
        def mm_dsp(x):
            clock[0] += 1e-4 + 1e-10 * x.numel()
            return x

        small, big = torch.ones((8, 8)), torch.ones((2048, 2048))
        for _ in range(14):
            mm(small)
            mm(big)
        assert mm.variant_for(small) == "reference"
        assert mm.variant_for(big) == "dsp"

    def test_system_ops_never_trialed(self):
        vpe, clock = make_vpe()

        @vpe.op("sys", system=True)
        def sysop(x):
            clock[0] += 0.5
            return x

        @vpe.variant("sys", variant="accel")
        def sysop2(x):
            clock[0] += 0.001
            return x

        for _ in range(10):
            sysop(X)
        assert sysop.variant_for(X) == "reference"

    def test_force_bumps_version(self):
        vpe, clock = make_vpe()
        register_pair(vpe, clock, 0.01, 0.002)
        v0 = vpe.controller.version
        vpe.controller.force("op", ("static",), "accel")
        assert vpe.controller.version == v0 + 1
        assert vpe.static_variant_name("op") == "accel"

    def test_cheapest_hint_trialed_first(self):
        vpe, clock = make_vpe()

        @vpe.op("multi")
        def ref(x):
            clock[0] += 0.01
            return x

        vpe.variant("multi", variant="bad", cost_hint=lambda: {"seconds": 9.0})(
            lambda x: (clock.__setitem__(0, clock[0] + 0.02), x)[1])
        vpe.variant("multi", variant="good", cost_hint=lambda: {"seconds": 0.1})(
            lambda x: (clock.__setitem__(0, clock[0] + 0.001), x)[1])
        for _ in range(6):
            ref(X)
        d = vpe.controller.decision("multi", shape_bucket(X))
        assert [v for e, v, _ in d.history if e == "trial"][0] == "good"

    def test_noise_gate_blocks_small_win(self):
        vpe, clock = make_vpe(hysteresis=0.0, noise_sigmas=5.0,
                              min_samples=4, trial_samples=4)
        ref_times = iter([0.008, 0.014] * 50)

        @vpe.op("noisy")
        def ref(x):
            clock[0] += next(ref_times)
            return x

        @vpe.variant("noisy", variant="accel")
        def accel(x):
            clock[0] += 0.0105
            return x

        for _ in range(20):
            ref(X)
        d = vpe.controller.decision("noisy", shape_bucket(X))
        assert d.selected == "reference"
        events = [e for e, _, _ in d.history]
        assert "trial" in events and "switch" not in events

    def test_state_dict_roundtrip(self):
        vpe, clock = make_vpe()
        op = register_pair(vpe, clock, 0.010, 0.002)
        small = torch.ones((8, 8))
        for _ in range(12):
            op(X)
            op(small)
        vpe2 = VPE(vpe.registry)
        vpe2.load_state_dict(vpe.state_dict())
        ctrl, ctrl2 = vpe.controller, vpe2.controller
        assert ctrl2.version == ctrl.version
        for key, d in ctrl._decisions.items():
            d2 = ctrl2._decisions[key]
            assert (d2.selected, d2.tried, d2.history) == \
                (d.selected, d.tried, d.history)
        b = shape_bucket(X)
        assert vpe2.profiler.mean("op", "accel", b) == pytest.approx(
            vpe.profiler.mean("op", "accel", b))
        assert isinstance(Controller(vpe.registry, vpe.profiler), Controller)


class TestRegistry:
    def test_duplicate_rejected(self):
        r = Registry()
        r.register_op("a")
        with pytest.raises(ValueError):
            r.register_op("a")
        r.register_variant("a", "v", lambda: None)
        with pytest.raises(ValueError):
            r.register_variant("a", "v", lambda: None)

    def test_user_ops_excludes_system(self):
        r = Registry()
        r.register_op("u")
        r.register_op("s", system=True)
        assert r.user_ops() == ["u"]


class TestDevice:
    def test_cuda_default_raises_without_card(self):
        """Entry points default to CUDA and never move to the CPU quietly."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        from repro_torch.models.convert import params_from_jax
        with pytest.raises(RuntimeError):
            params_from_jax({"w": np.ones(2, np.float32)})

    def test_cpu_and_unknown(self):
        assert resolve_device("cpu") == torch.device("cpu")
        with pytest.raises(ValueError):
            resolve_device("meta")
