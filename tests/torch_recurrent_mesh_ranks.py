"""What each rank of ``tests/test_torch_recurrent_mesh.py`` runs, in a process
of its own (``spawn_ranks``).  Kept apart from the test file so that a
rank imports no JAX: the JAX side runs only in the pytest process.  Every
function returns plain Python and numpy values, by rank."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.group import MeshGroups
from repro_torch.models import model as model_lib
from repro_torch.optim import compression
from repro_torch.runtime.train_loop import MeshShard, TrainLoop
from torch_train_mesh_ranks import (BATCH, SEQ, STEPS, _digest, _metrics, _whole,
                                    data_for, loop_config)

RWKV, ZAMBA, WHISPER = "rwkv6-7b", "zamba2-1.2b", "whisper-base"
FRAMES_SEED = 3


def reduced(arch):
    return get_config(arch).reduced()


class FramesStream:
    """``data_for``'s batches with seeded stub frames (B, source_len,
    d_model) f32 beside them, for the encoder-decoder (the JAX side draws
    the same ones through this class)."""

    def __init__(self, cfg, batch=BATCH, seq=SEQ):
        self.cfg, self.base, self.batch = cfg, data_for(cfg, batch, seq), batch

    def batch_at(self, step):
        out = dict(self.base.batch_at(step))
        rng = np.random.default_rng((FRAMES_SEED, step))
        out["frames"] = rng.standard_normal(
            (self.batch, self.cfg.source_len, self.cfg.d_model)).astype(np.float32)
        return out


def stream_for(cfg):
    return FramesStream(cfg) if cfg.family == "encdec" else data_for(cfg)


def case_loop(mesh, case):
    """The case's TrainLoop on ``mesh`` from the WHOLE params the parent
    converted from the reference's (``case["fsdp"]``: cut over data too)."""
    cfg = dataclasses.replace(reduced(case["arch"]), **case.get("cfg", {}))
    params = pytree.tree_map(torch.clone, case["params"])
    return TrainLoop(cfg, loop_config(**case.get("loop", {})), stream_for(cfg),
                     params=params, device="cpu", mesh=mesh,
                     fsdp=case.get("fsdp", False))


def train_case(mesh, case):
    """The completed gradients of the first batch, then 3 steps: the
    metrics, the gathered state, each leaf's digest."""
    loop = case_loop(mesh, case)
    placed = loop.prepare(loop.data.batch_at(0))
    _, grads = loop._step_fn.grads(loop.params, placed)
    out = {"grads": {k: v.numpy() for k, v in sharding._walk(grads)}}
    loop.run(STEPS)
    out["metrics"] = _metrics(loop.metrics_log)
    out["whole"] = _whole(loop)
    out["digests"] = {k: _digest(v) for k, v in sharding._walk(loop.params)}
    return out


# -- the lockstep cache a rank holds -------------------------------------------------------

def cache_cut(cfg, mp, m, key, shape):
    """(dim, start, size), a ``sharding.Runs``, or None: rank ``m``'s slice of
    the whole lockstep cache leaf ``key`` (``"['S']"``, ``"['macro_ssm']['h']"``,
    ``"['k']"``…) of ``shape``: the heads it holds (the KV heads its query
    heads read; each state's heads are its third dim from the end), Mamba2's
    x conv channels with B/C whole."""
    plan = sharding.shard_plan(cfg, mp)
    name = key.rsplit("['", 1)[1][:-2]
    heads = len(shape) - 3
    if plan.mixer and name in ("S", "h"):
        return heads, m * plan.mixer_heads, plan.mixer_heads
    if plan.mixer and name == "conv":
        return sharding._mamba_runs(cfg, plan, m, len(shape) - 1, "conv")
    if plan.attn and name in ("k", "v", "xk", "xv"):
        return heads, plan.kv_head0(m, cfg.num_heads, cfg.num_kv_heads), plan.kv_heads
    return None


def shard_cache(cfg, mp, m, cache):
    """Rank ``m``'s part of a whole lockstep cache (tensor leaves)."""
    out = {}
    for key, t in sharding._walk(cache):
        cut = cache_cut(cfg, mp, m, key, tuple(t.shape)) if t.ndim else None
        out[key] = sharding.cut_leaf(t, [cut]) if cut is not None else t
    return sharding._unflatten(cache, out)


def _np(tree):
    return {k: v.float().numpy() for k, v in sharding._walk(tree)}


def lockstep_case(mesh, case):
    """Under the rank's scope, with its shard of the params: the lockstep
    cache ``model.init_cache`` gives at the shard's config (each leaf's
    shape and dtype), the prefill's last logits and filled cache from it,
    then 4 decode steps from the reference's prefill cache cut to the
    rank's heads (``case["cache"]``, K/V held in f32), fed ``case["steps"]``:
    each step's logits and the final cache."""
    cfg = reduced(case["arch"])
    shard = MeshShard(cfg, mesh)
    params = shard.shard(pytree.tree_map(torch.clone, case["params"]))
    local = shard.local_cfg
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    B, S = batch["tokens"].shape
    out = {}
    with torch.no_grad(), shard.context():
        cache = model_lib.init_cache(local, B, case["max_len"], torch.device("cpu"))
        out["init"] = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                       for k, v in sharding._walk(cache)}
        cache = {k: (v.float() if k in ("k", "v") else v) for k, v in cache.items()}
        filled, logits = model_lib.prefill(local, params, batch, cache)
        out["prefill"], out["prefill_cache"] = logits.numpy(), _np(filled)
        cache = shard_cache(cfg, mesh.mp, mesh.m, case["cache"])
        steps = []
        for i in range(case["steps"].shape[1]):
            tok = torch.from_numpy(case["steps"][:, i:i + 1])
            cache, logits = model_lib.decode_step(local, params, cache, tok)
            steps.append(logits.numpy())
        out["decode"], out["decode_cache"] = steps, _np(cache)
    return out


def ef_case(mesh, case):
    """ErrorFeedback of the rank's slices of the whole ``grads``/``residual``
    (numpy, the params' nesting) in the whole leaves' blocks; the outputs
    gathered leaf by leaf."""
    cfg = reduced(case["arch"])
    to_t = lambda tree: pytree.tree_map(torch.from_numpy, tree)  # noqa: E731
    shard = MeshShard(cfg, mesh)
    shard.bind(to_t(case["grads"]))
    g, e = shard.shard(to_t(case["grads"])), shard.shard(to_t(case["residual"]))
    comp, res = compression.ErrorFeedback.apply(g, e, splits=shard.ef_splits(),
                                                group=mesh.model, comm=mesh.group)
    out = {}
    for name, tree in (("comp", comp), ("res", res)):
        whole = {}
        for key, leaf in sharding._walk(tree):
            parts = [torch.empty_like(leaf) for _ in range(mesh.mp)]
            mesh.group.all_gather_(parts, leaf.contiguous(), group=mesh.model)
            whole[key] = sharding.unshard_leaf(cfg, mesh.mp, key, parts).numpy()
        out[name] = whole
    return out


def mesh_cases(group, shape, cases):
    """Every case of one mesh shape, by name."""
    mesh = MeshGroups(group, *shape)
    fns = {"train": train_case, "lockstep": lockstep_case, "ef": ef_case}
    return {case["name"]: fns[case["kind"]](mesh, case) for case in cases}

