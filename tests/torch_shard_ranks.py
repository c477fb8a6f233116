"""What each rank of ``tests/test_torch_shard.py`` runs, in a process of its
own (``spawn_ranks``).  Kept apart from the test file so that a rank
imports no JAX: the JAX side runs only in the pytest process.  Every
function returns plain Python and numpy values, by rank."""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import VPE
from repro_torch.distributed.group import ShardScope, shard_scope
from repro_torch.distributed.sharding import shard_params, shard_plan
from repro_torch.distributed.straggler import StepWatchdog
from repro_torch.models import kvcache, moe
from repro_torch.runtime import serve_loop as tserve
from repro_torch.runtime.serve_faults import FaultPlan, FaultSpec

LAYOUTS = ("contiguous", "paged", "auto")
ENGINE_KW = dict(slots=2, max_len=48, block_size=8)


def workload(vocab):
    """``tests/test_mesh_parity.py``'s six requests."""
    rng = np.random.default_rng(21)
    return [tserve.Request(rid=i,
                           prompt=rng.integers(0, vocab,
                                               int(rng.integers(5, 13))).astype(np.int32),
                           max_new_tokens=6)
            for i in range(6)]


def serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    eng.check_kv()
    return {r.rid: [int(t) for t in r.out] for r in done}


def sharded(group, cfg, params, mesh, **kw):
    return tserve.make_serve_engine(
        cfg, params, mesh_shape=mesh, mesh_devices=["cpu"] * (mesh[0] * mesh[1]),
        shard_group=group, **{**ENGINE_KW, **kw})


class KernelCalls:
    """Counts the model's calls of the paged kernel entry points (on the
    CPU they run the plain versions, and the wrappers count nothing)."""

    def __init__(self):
        self.decode = self.prefill = 0
        self._decode = kvcache.paged_decode_attention_kernel
        self._prefill = kvcache.paged_prefill_attention_kernel
        kvcache.paged_decode_attention_kernel = self._count("decode", self._decode)
        kvcache.paged_prefill_attention_kernel = self._count("prefill", self._prefill)

    def _count(self, name, fn):
        def call(*a, **k):
            setattr(self, name, getattr(self, name) + 1)
            return fn(*a, **k)
        return call

    def remove(self):
        kvcache.paged_decode_attention_kernel = self._decode
        kvcache.paged_prefill_attention_kernel = self._prefill
        return self.decode, self.prefill


def layouts_and_kernels(group, arch, params, mesh):
    """``arch`` reduced on ``mesh``: the workload's tokens on every layout,
    then on the paged layout with both kernel variants pinned (chunked
    prefill, fused horizons of 4), with the kernel entry points' calls,
    the resolved variants and the replicas' completions."""
    cfg = get_config(arch).reduced()
    out = {"mismatch": 0}
    for layout in LAYOUTS:
        eng = sharded(group, cfg, params, mesh, kv_layout=layout)
        out[layout] = serve(eng, workload(cfg.vocab_size))
        out["mismatch"] += eng.stats.shard_token_mismatch
    calls = KernelCalls()
    try:
        eng = sharded(group, cfg, params, mesh, kv_layout="paged", prefill_chunk=8,
                      decode_horizon=4, decode_impl="cuda", prefill_kernel="cuda")
        out["pinned"] = serve(eng, workload(cfg.vocab_size))
    finally:
        out["kernel_calls"] = calls.remove()
    engines = getattr(eng, "engines", [eng])
    out["mismatch"] += eng.stats.shard_token_mismatch
    out["resolved"] = (engines[0]._resolve_impl("cuda"),
                       engines[0]._resolve_kernel("cuda"))
    out["replica_completed"] = [len(e.completed) for e in engines]
    out["heads"] = (engines[0].cfg.num_heads, engines[0].cfg.num_kv_heads)
    out["pool_heads"] = int(engines[0].page_pool["k"].shape[2])
    return out


def moe_block_cfg(num_experts: int) -> ModelConfig:
    """A one-layer MoE config around ``test_torch_moe.py``'s block spec,
    at a capacity factor tight enough to drop assignments."""
    return ModelConfig(name="moe-block", family="moe", num_layers=1, d_model=32,
                       num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=16,
                       num_experts=num_experts, num_shared_experts=2, top_k=2,
                       moe_d_ff=16, capacity_factor=0.25, dtype="float32")


def moe_block(group, num_experts, block_params, x, groups):
    """The MoE block over this rank's shard of ``block_params`` (the layer's
    ``moe_*`` leaves without the L axis), under its shard scope."""
    from repro_torch.models.transformer import moe_spec
    cfg = moe_block_cfg(num_experts)
    mp = group.world
    full = {"layers": {f"moe_{k}": v[None] for k, v in block_params.items()}}
    local, _ = shard_params(cfg, full, mp, group.rank)
    p = {k[len("moe_"):]: v[0] for k, v in local["layers"].items()}
    plan = shard_plan(cfg, mp)
    with shard_scope(ShardScope(group, plan)):
        y = moe.moe_block(p, moe_spec(cfg), torch.from_numpy(x), groups=groups)
    return dict(mode=plan.moe, out=y.numpy(),
                experts=int(p["experts_gate"].shape[0]),
                hidden=int(p["experts_gate"].shape[-1]))


def mp2(group, qparams, mparams, block):
    """Every case at (1, 2), qwen3-8b and qwen2-moe-a2.7b reduced, and the
    MoE block split by experts."""
    return dict(qwen=layouts_and_kernels(group, "qwen3-8b", qparams, (1, 2)),
                moe=layouts_and_kernels(group, "qwen2-moe-a2.7b", mparams, (1, 2)),
                block=moe_block(group, *block))


def mp4(group, qparams, block):
    """(1, 4), where reduced qwen3-8b's Hkv = 2 does not split, and the MoE
    block split by hidden columns."""
    return dict(qwen=layouts_and_kernels(group, "qwen3-8b", qparams, (1, 4)),
                block=moe_block(group, *block))


def dp2mp2(group, qparams):
    return dict(qwen=layouts_and_kernels(group, "qwen3-8b", qparams, (2, 2)))


AGREE_KW = dict(slots=2, max_len=64, block_size=8, kv_layout="paged",
                decode_impl="auto", prefill_kernel="auto", prefill_chunk="auto",
                chunk_choices=(8, 16), decode_horizon="auto",
                horizon_choices=(2, 4), spec_draft="auto")


def agree_requests(vocab):
    """Eight requests, each prompt twice (so drafts land), with deadlines
    that rank 0's clock never reaches."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
               for n in rng.integers(6, 20, 4)]
    return [tserve.Request(rid=i, prompt=prompts[i % 4], max_new_tokens=10,
                           deadline_s=600.0)
            for i in range(8)]


def agreement(group, qparams):
    """Rank 1 reads a clock that runs 1000 times fast and jitters, and its
    watchdog trips on every fence; every axis is ``auto``.  Returns each
    rank's log of decisions (rank 0's values, every call of ``_decide``),
    its decode and verify calls, its tokens and mismatch count; then a
    submission that differs on rank 1 (the error each rank raised); then
    a decode fault plan on the pinned kernel variant (the step of each
    demotion) and a clean run."""
    cfg = get_config("qwen3-8b").reduced()
    real = time.perf_counter
    jitter = np.random.default_rng(group.rank)
    if group.rank == 1:
        tserve.time = types.SimpleNamespace(
            perf_counter=lambda: real() * 1000.0 + float(jitter.random()))
    watchdog = (StepWatchdog(clock=tserve.time.perf_counter, multiplier=0.0,
                             min_budget_s=0.0)
                if group.rank == 1 else StepWatchdog())
    vpe = VPE(controller_kwargs=dict(min_samples=2, trial_samples=2))
    eng = sharded(group, cfg, qparams, (1, 2), vpe=vpe, watchdog=watchdog,
                  **AGREE_KW)
    decisions, calls = [], []
    decide, launch, verify = eng._decide, eng.graphs.launch, eng.graphs.verify

    def logged(fn):
        value = decide(fn)
        decisions.append(value)
        return value

    eng._decide = logged
    eng.graphs.launch = lambda impl, H: (calls.append(("decode", impl, H)),
                                         launch(impl, H))[1]
    eng.graphs.verify = lambda toks: (calls.append(("verify", toks.shape[1])),
                                      verify(toks))[1]
    out = dict(tokens=serve(eng, agree_requests(cfg.vocab_size)),
               decisions=decisions, calls=calls,
               mismatch=eng.stats.shard_token_mismatch,
               own_trips=watchdog.trips, trips=eng.stats.watchdog_trips,
               demotions=dict(eng.stats.demotions),
               spec_calls=eng.stats.spec_calls,
               failed=dict(eng.stats.failed_by_reason))
    tserve.time = time
    prompt = np.array([1, 2, 3 + group.rank], np.int32)
    try:
        eng.submit(tserve.Request(rid=99, prompt=prompt, max_new_tokens=2))
        out["mismatched_submit"] = None
    except ValueError as e:
        out["mismatched_submit"] = str(e)

    fault_kw = dict(kv_layout="paged", decode_impl="cuda", prefill_kernel="cuda",
                    prefill_chunk=8)
    plan = FaultPlan([FaultSpec("decode", "device", 2)])
    eng = sharded(group, cfg, qparams, (1, 2), fault_plan=plan, **fault_kw)
    demoted = []
    demote = eng._demote
    eng._demote = lambda rung: (demoted.append((rung, eng.stats.decode_steps)),
                                demote(rung))[1]
    out["faulted"] = serve(eng, workload(cfg.vocab_size))
    out["fault_demotions"] = demoted
    out["fault_stats"] = (eng.stats.device_faults, eng.stats.repromotions)
    out["clean"] = serve(sharded(group, cfg, qparams, (1, 2), **fault_kw),
                         workload(cfg.vocab_size))
    return out
