"""Faults and deadlines of the port against ``repro`` (after
tests/test_serve_faults.py): ``FaultPlan`` counting, validation and seeded
storms equal to the reference's; the port's engine and the JAX engine
under the same plan — tokens, ``failed_by_reason``, demotions (rung names
``*_pallas`` of the reference read ``*_cuda``), re-promotions and the
device, numeric and watchdog counters equal — across every rung of the
ladder, NaN quarantine, injected stalls, a real watchdog trip on an
injected clock, deadlines queued and resident and the queue bound; exact
resume against the fault-free run; the proposer never learning a
quarantined token; and the engine chaos gate.

Reduced qwen3-8b in f32, weights carried across with ``params_from_jax``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.distributed import straggler as jstraggler  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import serve_faults as jfaults  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import straggler as tstraggler  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_faults as tfaults  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime.spec_decode import NGramProposer  # noqa: E402

torch.set_num_threads(1)
MAX_LEN = 64
# the reference's names for the kernel variants and the rungs they head
KERNEL = {"cuda": "pallas", "gather": "gather", "grouped": "grouped"}
RUNG = {"decode_pallas": "decode_cuda", "prefill_pallas": "prefill_cuda",
        "spec": "spec", "horizon": "horizon"}


@pytest.fixture(scope="module")
def setup():
    cfg = ARCHS["qwen3-8b"].reduced()
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_config("qwen3-8b").reduced(), jp, tp


def make_reqs(mod, vocab, seed, plens=(8, 5, 11, 7), maxnew=(16, 10, 12, 14)):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, p).astype(np.int32),
                        max_new_tokens=m)
            for i, (p, m) in enumerate(zip(plens, maxnew))]


def survivors(done):
    return {r.rid: [int(t) for t in r.out] for r in done if r.status == "done"}


def fault_record(eng):
    st = eng.stats
    return dict(failed_by_reason=dict(st.failed_by_reason),
                demotions={RUNG.get(k, k): v for k, v in st.demotions.items()},
                repromotions=st.repromotions, device_faults=st.device_faults,
                numeric_faults=st.numeric_faults,
                watchdog_trips=st.watchdog_trips)


def assert_failure_records_complete(done):
    for r in done:
        if r.status != "failed":
            continue
        assert r.error in tserve.FAIL_REASONS, r.error
        assert r.error_detail
        assert r.done and r.done_t >= r.submit_t > 0.0
        if r.admit_step < 0:
            assert r.queue_wait_s == r.done_t - r.submit_t


def run_port(setup, reqs, specs=(), **kw):
    _, tcfg, _, tp = setup
    kw = {"slots": 2, "max_len": MAX_LEN, "kv_layout": "paged", **kw}
    plan = tfaults.FaultPlan([tfaults.FaultSpec(*s) for s in specs]) if specs else None
    eng = tserve.ContinuousBatchingEngine(tcfg, tp, fault_plan=plan, device="cpu", **kw)
    for r in reqs:
        eng.submit(r)
    done = sorted(eng.run(), key=lambda r: r.rid)
    return done, eng, plan


def both(setup, specs, seed, reqs_kw=None, watchdogs=None, **kw):
    """The same plan (``specs``: (site, kind, at, slot) tuples) and
    requests on the JAX engine and the port's; the port's kernel names
    are given and mapped for the reference.  Returns (reference done,
    reference engine, port done, port engine, port plan)."""
    cfg, tcfg, jp, tp = setup
    reqs_kw = reqs_kw or {}
    jkw = {"slots": 2, "max_len": MAX_LEN, "kv_layout": "paged", **kw}
    for key in ("decode_impl", "prefill_kernel"):
        if key in jkw:
            jkw[key] = KERNEL[jkw[key]]
    jplan = jfaults.FaultPlan([jfaults.FaultSpec(*s) for s in specs])
    jw, tw = watchdogs() if watchdogs else (kw.get("watchdog"), kw.get("watchdog"))
    jkw["watchdog"] = jw
    jeng = jserve.ContinuousBatchingEngine(cfg, jp, fault_plan=jplan, **jkw)
    for r in make_reqs(jserve, cfg.vocab_size, seed, **reqs_kw):
        jeng.submit(r)
    jdone = sorted(jeng.run(), key=lambda r: r.rid)
    tdone, teng, tplan = run_port(setup, make_reqs(tserve, tcfg.vocab_size, seed,
                                                   **reqs_kw),
                                  specs, **{**kw, "watchdog": tw})
    if specs:
        assert [(s.site, s.kind, s.at) for s in tplan.injected] == \
            [(s.site, s.kind, s.at) for s in jplan.injected]
    assert survivors(tdone) == survivors(jdone)
    assert [r.status for r in tdone] == [r.status for r in jdone]
    assert [r.error for r in tdone] == [r.error for r in jdone]
    assert fault_record(teng) == fault_record(jeng)
    teng.check_kv()
    assert teng.pages.drained
    assert_failure_records_complete(tdone)
    return jdone, jeng, tdone, teng, tplan


# -- the plan ----------------------------------------------------------------------

def test_take_counts_per_site_and_fires_once():
    plan = tfaults.FaultPlan([tfaults.FaultSpec("decode", "device", 1),
                              tfaults.FaultSpec("fused", "nan", 0, slot=1)])
    assert plan.take("decode") is None
    assert plan.peek("decode").at == 1
    hit = plan.take("decode")
    assert hit.kind == "device" and hit in plan.injected
    assert plan.take("decode") is None
    assert not plan.exhausted and plan.remaining == 1
    assert plan.take("fused").slot == 1
    assert plan.exhausted and len(plan) == 2


def test_spec_validation():
    for args in (("warp", "device", 0), ("decode", "explode", 0),
                 ("page_alloc", "nan", 0), ("decode", "device", -1)):
        with pytest.raises(ValueError):
            tfaults.FaultSpec(*args)
    with pytest.raises(ValueError):
        tfaults.FaultPlan([tfaults.FaultSpec("decode", "device", 0),
                           tfaults.FaultSpec("decode", "nan", 0)])
    assert tfaults.SITES == jfaults.SITES and tfaults.KINDS == jfaults.KINDS


@pytest.mark.parametrize("seed", [0, 5, 7, 13])
def test_seeded_plans_equal_reference(seed):
    """The same seed draws the reference's storm, spec for spec, over every
    site and over the engine's five."""
    for kw in (dict(slots=4), dict(span=40, slots=4,
                                   sites=("decode", "fused", "spec", "prefill",
                                          "page_alloc"))):
        for n in (4, 8, 10):
            want = jfaults.FaultPlan.seeded(seed, n, **kw)
            got = tfaults.FaultPlan.seeded(seed, n, **kw)
            assert [(s.site, s.kind, s.at, s.slot, s.note) for s in got.specs] \
                == [(s.site, s.kind, s.at, s.slot, s.note) for s in want.specs]


# -- the ladder against the reference ------------------------------------------------

def test_every_rung_of_the_ladder(setup):
    """Both kernels pinned, spans of 4, chunks of 4: a prefill device
    fault demotes the prefill kernel, a verify fault speculation, a fused
    fault (once speculation is off) the horizon, a stalled single step
    (once the horizon is down) the decode kernel; each re-promotes after
    its probation, and the survivors are the fault-free run's."""
    specs = [("prefill", "device", 1, None), ("spec", "device", 0, None),
             ("fused", "device", 0, None), ("decode", "stall", 0, None)]
    kw = dict(decode_impl="cuda", prefill_kernel="cuda", decode_horizon=4,
              spec_draft=4, prefill_chunk=4, watchdog=True, probation_steps=2)
    _, _, done, eng, plan = both(setup, specs, 1, **kw)
    assert plan.exhausted
    assert set(eng.stats.demotions) == {"prefill_cuda", "spec", "horizon",
                                        "decode_cuda"}
    assert eng.stats.repromotions == 4 and not eng._demoted
    assert eng.stats.failed_by_reason == {}
    ref, _, _ = run_port(setup, make_reqs(tserve, setup[1].vocab_size, 1),
                         **{k: v for k, v in kw.items() if k != "watchdog"})
    assert survivors(done) == survivors(ref)


@pytest.mark.parametrize("budget,failed", [(3, 0), (1, 2)])
def test_bottom_rung_charges_requests(setup, budget, failed):
    """A device fault at the safe bottom (grouped decode) blames the
    requests: absorbed with a budget of 3, terminal ``device_fault`` with
    a budget of 1."""
    _, _, done, eng, _ = both(setup, [("decode", "device", 1, None)], 0,
                              decode_impl="grouped", prefill_kernel="gather",
                              max_request_faults=budget)
    assert eng.stats.device_faults == 1 and not eng.stats.demotions
    assert eng.stats.failed_by_reason.get("device_fault", 0) == failed


def test_page_alloc_faults_roll_back(setup):
    """Allocation faults in a placement and in decode growth: the
    placement unwinds all or nothing, the grower is preempted; the pool
    stays audit-clean and the survivors are the fault-free run's."""
    _, _, done, eng, plan = both(setup, [("page_alloc", "device", 0, None),
                                         ("page_alloc", "device", 5, None)], 3,
                                 block_size=8)
    assert plan.exhausted and eng.stats.device_faults == 2
    ref, _, _ = run_port(setup, make_reqs(tserve, setup[1].vocab_size, 3), block_size=8)
    assert survivors(done) == survivors(ref)


@pytest.mark.parametrize("specs,kw", [
    ([("spec", "nan", 1, 0), ("prefill", "nan", 1, None)],
     dict(decode_horizon=4, spec_draft=4, prefill_chunk=4)),
    ([("decode", "nan", 0, 0), ("fused", "nan", 1, 1)], dict(decode_horizon=4)),
])
def test_nan_quarantines_the_slot_and_resumes_exactly(setup, specs, kw):
    """Poisoned logits at a verify, a prefill chunk, a single step and a
    fused call: only the poisoned slot is quarantined, nothing of the span
    is committed for it, and it resumes to the fault-free tokens; the
    proposer never learns a poisoned token."""
    _, _, done, eng, plan = both(setup, specs, 4, **kw)
    assert plan.exhausted and eng.stats.numeric_faults >= 2
    assert eng.stats.failed_by_reason == {}
    ref, _, _ = run_port(setup, make_reqs(tserve, setup[1].vocab_size, 4), **kw)
    assert survivors(done) == survivors(ref)
    assert any(r.preemptions or r.faults for r in done)
    if eng.proposer is not None:
        assert all(v >= 0 for v in eng.proposer._table.values())


def test_nan_never_seeds_the_proposer():
    p = NGramProposer(order=3)
    p.observe(0, [5, 6, -1, 7])
    assert all(v >= 0 for v in p._table.values())
    assert all(t >= 0 for t in p._ctx[0])


def test_injected_stall_demotes_the_horizon(setup):
    _, _, done, eng, plan = both(setup, [("fused", "stall", 0, None)], 5,
                                 decode_horizon=4, watchdog=True, probation_steps=2)
    assert plan.exhausted
    assert eng.stats.watchdog_trips == 1 and eng.watchdog.trips == 1
    assert eng.stats.demotions == {"horizon": 1}


def _scripted_clocks(slow=(3, 9)):
    """Two clocks for two watchdogs: each ``guard`` reads one twice, and
    fence k takes 10 s if k is in ``slow``, else 10 ms."""
    def clock():
        state = {"t": 0.0, "n": 0}

        def read():
            k = state["n"]
            state["n"] += 1
            if k % 2:
                state["t"] += 10.0 if k // 2 in slow else 0.01
            return state["t"]
        return read
    return (jstraggler.StepWatchdog(clock=clock()),
            tstraggler.StepWatchdog(clock=clock()))


def test_real_watchdog_trip_on_an_injected_clock(setup):
    """The watchdog's own path: a real ``StepWatchdog`` whose clock makes
    the 4th and 10th fences take 10 s trips there (``StragglerTimeout``),
    the late tokens are committed, and a tripped kernel step demotes the
    decode kernel."""
    _, _, done, eng, _ = both(setup, [], 6, watchdogs=_scripted_clocks,
                              decode_impl="cuda", prefill_kernel="cuda",
                              probation_steps=3)
    assert eng.stats.watchdog_trips == 2 == eng.watchdog.trips
    assert eng.stats.demotions == {"decode_cuda": 2}
    ref, _, _ = run_port(setup, make_reqs(tserve, setup[1].vocab_size, 6))
    assert survivors(done) == survivors(ref)


# -- deadlines and the queue bound ---------------------------------------------------

def _deadline_run(mod, eng, vocab):
    reqs = make_reqs(mod, vocab, 7, plens=(8, 5, 11, 7, 6), maxnew=(16, 10, 12, 14, 4))
    reqs[2].deadline_s = 0.0          # expired the moment it queues
    for r in reqs:
        eng.submit(r)
    while reqs[0].admit_step < 0 and eng.step():
        pass
    reqs[0].deadline_s = 1e-9         # resident, now long past
    return sorted(eng.run(), key=lambda r: r.rid)


def test_deadlines_and_queue_bound(setup):
    """With ``max_queue_depth=4`` the fifth submission is shed
    (``capacity``); a request expired in the queue never burns a step, and
    one whose deadline passes while resident stops at the next step
    boundary — ``deadline`` both, with complete records; the same on both
    engines."""
    cfg, tcfg, jp, tp = setup
    kw = dict(slots=2, max_len=MAX_LEN, kv_layout="paged", max_queue_depth=4)
    jdone = _deadline_run(jserve, jserve.ContinuousBatchingEngine(cfg, jp, **kw),
                          cfg.vocab_size)
    teng = tserve.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    tdone = _deadline_run(tserve, teng, tcfg.vocab_size)
    assert [(r.status, r.error) for r in tdone] == [(r.status, r.error) for r in jdone]
    assert survivors(tdone) == survivors(jdone)
    st = teng.stats
    assert st.failed_by_reason == {"capacity": 1, "deadline": 2}
    assert tdone[2].out == [] and tdone[4].error == "capacity"
    assert st.rejected == 2 and len(st.queue_wait_s) + st.rejected == 5
    assert_failure_records_complete(tdone)
    teng.check_kv()
    assert teng.num_active == 0 and teng.pages.drained


# -- the chaos gate ---------------------------------------------------------------

def test_engine_chaos_gate(setup):
    """Device faults, NaN logits, stalls, allocation faults and a deadline
    across every span type: the engine never raises, the survivors are the
    fault-free run's, every failure has a reason code and a complete
    record, every submission is accounted for once, and no page leaks."""
    _, tcfg, _, _ = setup
    mk = lambda: make_reqs(tserve, tcfg.vocab_size, 13,
                           plens=(8, 5, 11, 7, 9, 6),
                           maxnew=(16, 12, 14, 10, 12, 16))
    ref, _, _ = run_port(setup, mk(), slots=3)
    specs = [("spec", "device", 0, None), ("spec", "nan", 1, 1),
             ("spec", "stall", 2, None), ("decode", "device", 0, None),
             ("decode", "nan", 2, 0), ("decode", "stall", 4, None),
             ("fused", "device", 0, None), ("prefill", "nan", 1, None),
             ("prefill", "stall", 3, None), ("page_alloc", "device", 2, None)]
    reqs = mk()
    reqs.append(tserve.Request(rid=len(reqs), prompt=np.arange(1, 7, dtype=np.int32),
                               max_new_tokens=4, deadline_s=0.0))
    done, eng, plan = run_port(setup, reqs, specs, slots=3, decode_horizon=4,
                               spec_draft=4, prefill_chunk=4, watchdog=True,
                               probation_steps=2)
    assert {"device", "nan", "stall"} <= {s.kind for s in plan.injected}
    st = eng.stats
    assert st.device_faults and st.numeric_faults and st.watchdog_trips
    assert st.demotions and st.failed_by_reason.get("deadline") == 1
    want = survivors(ref)
    for rid, out in survivors(done).items():
        assert out == want[rid], f"rid {rid} diverged under chaos"
    assert_failure_records_complete(done)
    assert len(done) == len(reqs)
    assert len(st.queue_wait_s) + st.rejected == len(reqs)
    assert st.failed_requests == sum(1 for r in done if r.status == "failed")
    eng.check_kv()
    assert eng.pages.drained
