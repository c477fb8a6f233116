"""What each rank of ``tests/test_torch_train_mesh.py`` runs, in a process
of its own (``spawn_ranks``).  Kept apart from the test file so that a
rank imports no JAX: the JAX side runs only in the pytest process.  Every
function returns plain Python and numpy values, by rank."""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.distributed import sharding
from repro_torch.distributed.group import MeshGroups
from repro_torch.distributed.straggler import StragglerTimeout
from repro_torch.models import model as model_lib
from repro_torch.optim import compression
from repro_torch.runtime.fault import SimulatedFault, run_with_recovery
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig

STEPS = 3
BATCH, SEQ, DATA_SEED = 4, 32, 1


def data_for(cfg, batch=BATCH, seq=SEQ):
    return SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch, seed=DATA_SEED))


def loop_config(**kw):
    base = dict(total_steps=STEPS, warmup_steps=1, log_every=0, enable_vpe=False,
                watchdog=False)
    return TrainLoopConfig(**{**base, **kw})


def case_loop(mesh, case, **loop_kw):
    """The case's TrainLoop on ``mesh`` (None: one device), from the WHOLE
    params the parent converted from the reference's; ``case["fsdp"]``
    cuts the state over the data axis too."""
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case.get("cfg", {}))
    params = pytree.tree_map(torch.clone, case["params"])
    return TrainLoop(cfg, loop_config(**{**case.get("loop", {}), **loop_kw}),
                     data_for(cfg), params=params, device="cpu", mesh=mesh,
                     fsdp=case.get("fsdp", False))


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def _whole(loop):
    """{key: numpy} of the gathered params, m and v (every rank of data
    rank 0's model group gathers, every rank under fsdp; rank 0 returns
    them, the others None)."""
    g = loop.mesh.groups
    tree = {"params": loop.params, "m": loop.opt_state["m"], "v": loop.opt_state["v"]}
    if g.d != 0 and not loop.mesh.fsdp:
        return None
    whole = sharding.map_leaves(tree, loop._gathered)
    return {k: v.numpy() for k, v in sharding._walk(whole)} if g.group.rank == 0 else None


def _metrics(log):
    return [(m["loss"], m["grad_norm"]) for m in log]


def grads_elsewhere(loop, placed):
    """The rank's completed gradients with the loss's forward under the
    rank's scope in this thread and its backward (so the remat's
    recomputation) in another, which does not see this thread's scope:
    on a card the backward runs in the autograd engine's thread."""
    leaves, spec = pytree.tree_flatten(loop.params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad(), loop.mesh.context():
        loss = model_lib.loss_fn(loop.local_cfg, pytree.tree_unflatten(leaves, spec),
                                 placed)
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(loss, leaves)
        except Exception as e:      # re-raised in the rank's own thread
            out["error"] = e
    t = threading.Thread(target=backward)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    grads = pytree.tree_unflatten(loop.mesh.sync(list(out["grads"])), spec)
    return {k: v.numpy() for k, v in sharding._walk(grads)}


def train_case(mesh, case):
    """3 steps; the metrics, the gathered state, each leaf's digest, and
    (``grads``) the rank's completed gradients of the first batch."""
    loop = case_loop(mesh, case)
    out = {}
    if case.get("grads"):
        placed = loop.prepare(loop.data.batch_at(0))
        _, grads = loop._step_fn.grads(loop.params, placed)
        out["grads"] = {k: v.numpy() for k, v in sharding._walk(grads)}
        out["grads_elsewhere"] = grads_elsewhere(loop, placed)
    if case.get("ckpt"):
        # rung 2 on a mesh: the same fault at the same step on every rank
        loop.loop_cfg.checkpoint_dir = case["ckpt"]
        loop.loop_cfg.checkpoint_every = 2
        fired = []

        def hook(step):
            if step == 2 and not fired:
                fired.append(step)
                raise SimulatedFault("injected")
        loop.fault_hook = hook
        out["restores"] = run_with_recovery(loop, STEPS)
    else:
        loop.run(STEPS)
    out["metrics"] = _metrics(loop.metrics_log)
    out["whole"] = _whole(loop)
    out["digests"] = {k: _digest(v) for k, v in sharding._walk(loop.params)}
    # the bytes of the storages the state holds: a slice that is a view of
    # the whole leaf counts the whole
    storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in pytree.tree_leaves((loop.params, loop.opt_state))}
    out["state_bytes"] = sum(storages.values())
    return out


def restore_case(mesh, case):
    """Restore the checkpoint another mesh wrote at step 2, then run step
    3: its metrics and the gathered state."""
    loop = case_loop(mesh, case, checkpoint_dir=case["restore"])
    assert loop.restore() and loop.step == 2
    loop.run(STEPS)
    return {"metrics": _metrics(loop.metrics_log), "whole": _whole(loop)}


def moe_misaligned(mesh, case):
    """An MoE config whose routing groups do not split over the data axis:
    the ValueError's message on every rank."""
    loop = case_loop(mesh, {**case, "cfg": {"moe_groups": 3}})
    try:
        loop.run(1)
    except ValueError as e:
        return str(e)
    return None


def ef_direct(mesh, grads, residual):
    """ErrorFeedback of the rank's slices of whole ``grads``/``residual``
    (dicts of numpy in the params' nesting, qwen3-8b reduced), in the
    whole leaves' blocks; the gathered outputs."""
    loop_cfg = get_config("qwen3-8b").reduced()
    from repro_torch.runtime.train_loop import MeshShard
    to_t = lambda tree: pytree.tree_map(torch.from_numpy, tree)  # noqa: E731
    shard = MeshShard(loop_cfg, mesh)
    shard.bind(to_t(grads))
    g, e = shard.shard(to_t(grads)), shard.shard(to_t(residual))
    comp, res = compression.ErrorFeedback.apply(g, e, splits=shard.ef_splits(),
                                                group=mesh.model)
    out = {}
    for name, tree in (("comp", comp), ("res", res)):
        whole = {}
        for key, leaf in sharding._walk(tree):
            parts = [torch.empty_like(leaf) for _ in range(mesh.mp)]
            torch.distributed.all_gather(parts, leaf.contiguous(), group=mesh.model)
            whole[key] = sharding.unshard_leaf(loop_cfg, mesh.mp, key, parts).numpy()
        out[name] = whole
    return out


class SkewedClock:
    """A rank's clock: ``scale`` times the real one, jumping ``late_s``
    ahead inside the watchdog's fence of each step in ``late_steps`` (the
    loop reads it four times a step: its start, the fence's start and end,
    its end)."""

    def __init__(self, scale, late_steps, late_s=30.0):
        self.scale, self.late_steps, self.late_s = scale, set(late_steps), late_s
        self.calls, self.offset = 0, 0.0

    def __call__(self):
        if self.calls % 4 == 2 and self.calls // 4 in self.late_steps:
            self.offset += self.late_s
        self.calls += 1
        return time.perf_counter() * self.scale + self.offset


# rank 0's late steps (two in a row: a restore), and another rank's, which
# no rank may follow
LEADER_LATE = (5, 6)
OTHER_LATE = (3, 8)
SKEW_STEPS = 10


def skewed_decisions(mesh, case, ckpt):
    """The VPE on, the watchdog on, every rank on its own skewed clock: the
    variants each step ran, the late verdicts, the restores and the
    metrics."""
    r = mesh.group.rank
    clock = SkewedClock(1.0 + 2.0 * r, LEADER_LATE if r == 0 else OTHER_LATE)
    loop = case_loop(mesh, case, enable_vpe=True, watchdog=True,
                     total_steps=SKEW_STEPS, checkpoint_every=2,
                     checkpoint_dir=ckpt)
    loop.clock = loop.watchdog.clock = clock
    impls, verdicts, restores = [], [], []
    run_step, restore = loop.run_step, loop.restore

    def step(batch):
        # the clock's step index counts every step run, replays included
        try:
            return run_step(batch)
        except StragglerTimeout:
            verdicts.append(loop.step)
            raise
        finally:
            impls.append(loop._bound_impl["attn_impl"])
    loop.run_step = step
    loop.restore = lambda: restores.append(loop.step) or restore()
    loop.run(SKEW_STEPS)
    return dict(impls=impls, verdicts=verdicts, restores=restores,
                metrics=_metrics(loop.metrics_log), trips=loop.watchdog.trips,
                report=loop.vpe.report())


def psum(group, xs):
    """compressed_psum of this rank's ``xs[rank]`` over every rank."""
    return compression.compressed_psum(torch.from_numpy(xs[group.rank])).numpy()


def mesh_cases(group, shape, cases, extras=None):
    """Every case of one mesh shape; ``extras``: the (2, 2) rank's EF,
    compressed_psum and clock cases."""
    mesh = MeshGroups(group, *shape)
    out = {}
    for case in cases:
        fn = {"train": train_case, "restore": restore_case,
              "moe_misaligned": moe_misaligned}[case["kind"]]
        out[case["name"]] = fn(mesh, case)
    extras = extras or {}
    if "ef" in extras:
        out["ef"] = ef_direct(mesh, *extras["ef"])
    if "psum" in extras:
        out["psum"] = psum(group, extras["psum"])
    if "skew" in extras:
        out["skew"] = skewed_decisions(mesh, *extras["skew"])
    return out
