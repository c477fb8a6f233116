"""The serve mesh's replica axis of the port against ``repro`` (after
tests/test_mesh_parity.py and tests/test_serve_faults.py): ``shard_bucket``
and its label; ``make_serve_engine`` mapping each mesh to the reference's
engine (``(1, 1)`` the single engine with unchanged keys, ``(2, 1)`` an
``EngineReplicaGroup``, too few cards refused; head sharding is
tests/test_torch_shard.py's); the group of
two replicas on ``mesh_devices=["cpu", "cpu"]`` sharing one queue, its
dispatch keys carrying the mesh, and its tokens equal to the JAX single
engine's on the contiguous and paged layouts (the reference's contract,
"dp group = single-device baseline"; the JAX group itself needs forced
host devices); replica failover — quarantine, migration, canary
re-admission, lost dispatches, ``replica_lost`` — and the group chaos gate,
survivors token-exact against the fault-free single engine; the launcher's
``--mesh`` (``2,1``, and ``1,2``: head sharding over two CPU ranks) and
both examples on the CPU.

Reduced qwen3-8b in f32, weights carried across with ``params_from_jax``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (VPE, bucket_label, occupancy_bucket,  # noqa: E402
                              shard_bucket)
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime.serve_faults import FaultPlan, FaultSpec  # noqa: E402

torch.set_num_threads(1)
MAX_LEN = 64
CPUS = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def setup():
    cfg = ARCHS["qwen3-8b"].reduced()
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_config("qwen3-8b").reduced(), jp, tp


def _workload(mod, vocab):
    rng = np.random.default_rng(21)
    return [mod.Request(rid=i,
                        prompt=rng.integers(0, vocab,
                                            int(rng.integers(5, 13))).astype(np.int32),
                        max_new_tokens=6)
            for i in range(6)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    eng.check_kv()          # zero leaked pages at drain
    return {r.rid: [int(t) for t in r.out] for r in done}


def make_reqs(rng, vocab, plens=(8, 5, 11, 7), maxnew=(16, 10, 12, 14)):
    return [tserve.Request(rid=i, prompt=rng.integers(0, vocab, p).astype(np.int32),
                           max_new_tokens=m)
            for i, (p, m) in enumerate(zip(plens, maxnew))]


def run_engine(tp, tcfg, reqs, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    mesh_shape = kw.pop("mesh_shape", (1, 1))
    if mesh_shape == (1, 1):
        kw["device"] = "cpu"
    else:
        kw["mesh_devices"] = ["cpu"] * (mesh_shape[0] * mesh_shape[1])
    eng = tserve.make_serve_engine(tcfg, tp, mesh_shape=mesh_shape, **kw)
    for r in reqs:
        eng.submit(r)
    return sorted(eng.run(), key=lambda r: r.rid), eng


def survivors(done):
    return {r.rid: [int(t) for t in r.out] for r in done if r.status == "done"}


def assert_failure_records_complete(done):
    for r in done:
        if r.status != "failed":
            continue
        assert r.error in tserve.FAIL_REASONS, r.error
        assert r.error_detail
        assert r.done and r.done_t >= r.submit_t > 0.0
        if r.admit_step < 0:
            assert r.queue_wait_s == r.done_t - r.submit_t


class TestShardBucket:
    def test_shard_segment_renders_in_label(self):
        bucket = occupancy_bucket(2, 4) + shard_bucket(1, 2)
        assert "mesh:dp1mp2" in bucket_label(bucket)
        assert bucket_label(occupancy_bucket(2, 4) + shard_bucket(2, 1)) == \
            "occ2/4slotsxmesh:dp2mp1"

    def test_distinct_meshes_are_distinct_keys(self):
        base = occupancy_bucket(2, 4)
        keys = {base + shard_bucket(1, 1), base + shard_bucket(1, 2),
                base + shard_bucket(2, 1), base + shard_bucket(2, 2)}
        assert len(keys) == 4

    def test_trivial_mesh_appends_nothing_to_engine_keys(self, setup):
        """(1,1) must be a bitwise no-op down to the dispatch keys."""
        _, tcfg, _, tp = setup
        eng = tserve.ContinuousBatchingEngine(tcfg, tp, slots=2, max_len=32,
                                              device="cpu")
        assert eng._shard_tail == ()


def test_labels_equal_reference():
    """The port's labels of SLO- and mesh-tailed keys are the reference's."""
    from repro.core import bucket_label as jlabel
    from repro.core import shard_bucket as jshard
    from repro.core import slo_pressure_bucket as jslo
    from repro_torch.core import slo_pressure_bucket
    for dp, mp in ((1, 2), (2, 1), (4, 2)):
        for slo in ((), (1, 2)):
            key = occupancy_bucket(3, 4) + (slo_pressure_bucket(*slo) if slo else ()) \
                + shard_bucket(dp, mp)
            jkey = occupancy_bucket(3, 4) + (jslo(*slo) if slo else ()) + jshard(dp, mp)
            assert key == jkey
            assert bucket_label(key) == jlabel(jkey)


class TestMakeServeEngine:
    def test_single_engine_keys_unchanged(self, setup):
        """``(1, 1)`` is the plain engine, and its VPE learns under exactly
        the keys a directly built engine's does."""
        _, tcfg, _, tp = setup
        decided = []
        for build in (tserve.ContinuousBatchingEngine, tserve.make_serve_engine):
            vpe = VPE(controller_kwargs=dict(min_samples=2, trial_samples=2))
            eng = build(tcfg, tp, slots=2, max_len=48, vpe=vpe, device="cpu")
            assert type(eng) is tserve.ContinuousBatchingEngine
            _run(eng, _workload(tserve, tcfg.vocab_size))
            decided.append(sorted(vpe.controller._decisions, key=repr))
        assert decided[0] == decided[1] and decided[0]

    def test_dp_returns_group(self, setup):
        _, tcfg, _, tp = setup
        grp = tserve.make_serve_engine(tcfg, tp, mesh_shape=(2, 1),
                                       mesh_devices=CPUS, slots=1, max_len=48)
        assert isinstance(grp, tserve.EngineReplicaGroup)
        assert grp.mesh_shape == (2, 1) and len(grp.engines) == 2
        # one device named twice: the replicas share the parameter tensors
        assert all(e.params is tp for e in grp.engines)
        assert all(e._shard_tail == shard_bucket(2, 1) for e in grp.engines)
        for name in ("submit", "step", "run", "check_kv"):
            assert callable(getattr(grp, name))
        assert grp.num_active == 0 and grp.completed == []
        assert isinstance(grp.stats, tserve.ServeStats)

    def test_too_few_devices_raise(self, setup):
        """The default placement needs dp cards; a CPU-only torch has none.
        A list of the wrong length raises too, and the group takes no
        single ``device``."""
        _, tcfg, _, tp = setup
        with pytest.raises(ValueError, match="needs 2 devices"):
            tserve.make_serve_engine(tcfg, tp, mesh_shape=(2, 1), slots=1,
                                     max_len=48)
        with pytest.raises(ValueError, match="needs 2 devices"):
            tserve.make_serve_engine(tcfg, tp, mesh_shape=(2, 1),
                                     mesh_devices=["cpu"], slots=1, max_len=48)
        with pytest.raises(ValueError, match="mesh_devices, not device"):
            tserve.make_serve_engine(tcfg, tp, mesh_shape=(2, 1),
                                     mesh_devices=CPUS, device="cpu")
        with pytest.raises(ValueError, match="dp > 1"):
            tserve.ContinuousBatchingEngine(tcfg, tp, mesh_shape=(2, 1),
                                            device="cpu")


class TestGroup:
    def test_dp_group_shares_one_queue(self, setup):
        """dp=2: both replicas serve, the shared queue drains, and the
        merged stats see every request exactly once."""
        _, tcfg, _, tp = setup
        group = tserve.make_serve_engine(tcfg, tp, mesh_shape=(2, 1),
                                         mesh_devices=CPUS, slots=1, max_len=48)
        reqs = _workload(tserve, tcfg.vocab_size)
        for r in reqs:
            group.submit(r)
        done = group.run()
        assert sorted(r.rid for r in done) == [r.rid for r in reqs]
        assert group.queue == []
        # with 1 slot per replica and 6 requests, a single replica
        # cannot have served them all
        per_replica = [len(e.completed) for e in group.engines]
        assert all(n > 0 for n in per_replica)
        assert len(group.stats.queue_wait_s) == len(reqs)
        group.check_kv()

    def test_shard_tail_reaches_dispatch_keys(self, setup):
        """The dp case of the reference's test: a group's decode
        selections are keyed per mesh configuration, and the shared VPE's
        labels carry the mesh."""
        _, tcfg, _, tp = setup
        vpe = VPE(controller_kwargs=dict(min_samples=2, trial_samples=2))
        eng = tserve.make_serve_engine(tcfg, tp, mesh_shape=(2, 1),
                                       mesh_devices=CPUS, slots=2, max_len=48,
                                       vpe=vpe)
        _run(eng, _workload(tserve, tcfg.vocab_size))
        keys = [b for (op, b) in vpe.controller._decisions
                if op == "serve_decode_impl"]
        assert keys and all("shard" in b and (2, 1) == b[-2:] for b in keys)
        assert all("xmesh:dp2mp1" in bucket_label(b) for b in keys)

    @pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
    def test_group_tokens_equal_jax_single_engine(self, setup, kv_layout):
        """dp group = single-device baseline, against the JAX engine."""
        cfg, tcfg, jp, tp = setup
        kw = dict(slots=2, max_len=48, kv_layout=kv_layout, block_size=8)
        want = _run(jserve.ContinuousBatchingEngine(cfg, jp, **kw),
                    _workload(jserve, cfg.vocab_size))
        grp = tserve.make_serve_engine(tcfg, tp, mesh_shape=(2, 1),
                                       mesh_devices=CPUS, **kw)
        got = _run(grp, _workload(tserve, tcfg.vocab_size))
        assert got == want
        assert all(len(e.completed) > 0 for e in grp.engines)
        if kv_layout == "paged":
            assert all(e.pages.drained for e in grp.engines)


class TestReplicaFailover:
    def test_quarantine_migration_and_canary_readmission(self, setup):
        """The top rung: a replica accumulating fault evidence past its
        budget is quarantined — its in-flight requests migrate to survivors
        and rerun token-exact — and a clean canary probe re-admits it.
        Canaries never appear in ``completed``."""
        _, tcfg, _, tp = setup
        mk = lambda: make_reqs(np.random.default_rng(10), tcfg.vocab_size,  # noqa: E731
                               plens=(8, 5, 11, 7, 6, 9),
                               maxnew=(12, 10, 12, 10, 8, 12))
        ref, _ = run_engine(tp, tcfg, mk())         # single-engine truth
        plan = FaultPlan([FaultSpec("decode", "device", 1),
                          FaultSpec("decode", "device", 3)])
        done, grp = run_engine(tp, tcfg, mk(), mesh_shape=(2, 1),
                               fault_plan=plan, replica_fault_budget=2,
                               max_request_faults=8)
        st = grp.stats
        assert st.replica_quarantines >= 1
        assert st.replica_readmissions == st.replica_quarantines
        assert st.canary_probes >= 1
        assert "replica quarantines" in st.summary()
        assert not grp.quarantined                     # group ends healthy
        assert survivors(done) == survivors(ref)       # migration is exact
        assert all(r.rid >= 0 for r in done)           # canaries filtered
        grp.check_kv()

    def test_lost_dispatch_charges_and_retries(self, setup):
        """A ``dispatch``-site fault loses the handoff: the request stays
        queued (charged one fault) and lands on the next pass — no request
        is lost, outputs stay exact."""
        _, tcfg, _, tp = setup
        mk = lambda: make_reqs(np.random.default_rng(11), tcfg.vocab_size)  # noqa: E731
        ref, _ = run_engine(tp, tcfg, mk())
        plan = FaultPlan([FaultSpec("dispatch", "device", 0)])
        done, grp = run_engine(tp, tcfg, mk(), mesh_shape=(2, 1),
                               fault_plan=plan)
        assert plan.exhausted
        assert survivors(done) == survivors(ref)
        assert sum(grp._dispatch_faults) == 1
        grp.check_kv()

    def test_replica_lost_reason_when_budget_spent(self, setup):
        """A request that keeps landing on dying replicas terminates as
        ``replica_lost`` instead of migrating forever."""
        _, tcfg, _, tp = setup
        plan = FaultPlan([FaultSpec("decode", "device", 0),
                          FaultSpec("decode", "device", 1),
                          FaultSpec("decode", "device", 2),
                          FaultSpec("decode", "device", 3)])
        done, grp = run_engine(tp, tcfg,
                               make_reqs(np.random.default_rng(12),
                                         tcfg.vocab_size),
                               mesh_shape=(2, 1), fault_plan=plan,
                               replica_fault_budget=1, max_request_faults=2)
        st = grp.stats
        assert st.replica_quarantines >= 1
        lost = [r for r in done if r.error == "replica_lost"]
        assert st.failed_by_reason.get("replica_lost", 0) == len(lost)
        assert_failure_records_complete(done)
        grp.check_kv()


def test_group_chaos_gate(setup):
    """The replica half of the chaos gate: device faults + a lost dispatch
    force quarantine and migration; the group never raises, ends with no
    replica quarantined, and survivors are token-exact."""
    _, tcfg, _, tp = setup
    mk = lambda: make_reqs(np.random.default_rng(14), tcfg.vocab_size,  # noqa: E731
                           plens=(8, 5, 11, 7, 6, 9, 10, 4),
                           maxnew=(12, 10, 12, 10, 8, 12, 6, 10))
    ref, _ = run_engine(tp, tcfg, mk())
    plan = FaultPlan([FaultSpec("decode", "device", 1),
                      FaultSpec("decode", "nan", 4),
                      FaultSpec("dispatch", "device", 1),
                      FaultSpec("decode", "device", 6)])
    done, grp = run_engine(tp, tcfg, mk(), mesh_shape=(2, 1),
                           fault_plan=plan, replica_fault_budget=2,
                           max_request_faults=8, watchdog=True)
    st = grp.stats
    assert st.replica_quarantines >= 1
    assert not grp.quarantined
    assert survivors(done) == survivors(ref)
    assert_failure_records_complete(done)
    grp.check_kv()


def test_group_deadline_sweep_and_queue_bound(setup):
    """The shared queue's admission bound and deadline sweep: submissions
    past the depth fail ``capacity`` at the group, an expired queued
    request fails ``deadline``, and every submission is accounted once."""
    _, tcfg, _, tp = setup
    reqs = make_reqs(np.random.default_rng(9), tcfg.vocab_size,
                     plens=(6,) * 5, maxnew=(4,) * 5)
    reqs[1].deadline_s = 0.0
    done, grp = run_engine(tp, tcfg, reqs, mesh_shape=(2, 1), slots=1,
                           max_queue_depth=3)
    assert grp.stats.failed_by_reason == {"capacity": 2, "deadline": 1}
    assert [r.rid for r in done if r.status == "done"] == [0, 2]
    assert len(grp.stats.queue_wait_s) + grp.stats.rejected == len(reqs)
    assert_failure_records_complete(done)


def test_launcher_mesh(capsys):
    """``--mesh 2,1 --device cpu,cpu --continuous`` serves through the
    group, and ``--mesh 1,2 --device cpu,cpu --continuous`` over two
    head-sharded ranks (rank 0's lines printed); ``--mesh 1,2`` on one
    device and ``--mesh 2,1`` without ``--continuous`` are refused."""
    base = ["--arch", "qwen3-8b", "--smoke", "--requests", "4",
            "--new-tokens", "3", "--max-len", "48"]
    tlaunch.main(base + ["--mesh", "2,1", "--device", "cpu,cpu", "--continuous"])
    out = capsys.readouterr().out
    assert "completed 4 requests [mesh 2x1]" in out
    assert "'shard', 2, 1):" in out         # the shared VPE's keys
    tlaunch.main(base + ["--mesh", "1,2", "--device", "cpu,cpu", "--continuous"])
    out = capsys.readouterr().out
    assert "completed 4 requests [mesh 1x2]" in out
    assert "'shard', 1, 2):" in out
    for bad, msg in ((["--mesh", "1,2", "--device", "cpu", "--continuous"],
                      "2 devices"),
                     (["--mesh", "2,1", "--device", "cpu,cpu"],
                      "requires --continuous"),
                     (["--mesh", "2,1", "--device", "cpu", "--continuous"],
                      "2 devices")):
        with pytest.raises(SystemExit):
            tlaunch.main(base + bad)
        assert msg in capsys.readouterr().err


def test_examples_on_cpu(capsys, tmp_path):
    """Both examples run on the CPU: the warm burst hits the prefix cache,
    and training takes its steps with finite losses."""
    from repro_torch.examples import serve_lm, train_lm
    out = serve_lm.main(device="cpu")
    assert len(out["tokens"]) == 8
    assert "prefix-cache" in capsys.readouterr().out
    metrics = train_lm.main(["--smoke", "--steps", "3", "--batch", "2",
                             "--seq", "32", "--device", "cpu",
                             "--ckpt", str(tmp_path)])
    assert len(metrics) == 3 and all(np.isfinite(m["loss"]) for m in metrics)
