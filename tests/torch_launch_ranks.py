"""What each rank of ``tests/test_torch_launch.py``'s gloo runs, in a process
of its own (``spawn_ranks``).  Kept apart from the test file so that a
rank imports no JAX."""

from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticStream, device_put_batch
from repro_torch.distributed.group import MeshGroups, ShardGroup
from repro_torch.launch.specs import CountingGroup
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import (MeshShard, init_opt_state, make_train_step,
                                            rank_rows)


class RecordingGroup(ShardGroup):
    """A rank's real group that also records each collective as the dry
    run's :class:`CountingGroup` does."""

    def __init__(self, group: ShardGroup) -> None:
        super().__init__(group.rank, group.world, group.backend)
        self.counter = CountingGroup(group.rank, group.world)

    def all_reduce_(self, x, group=None, op="sum"):
        self.counter.all_reduce_(x, group, op)
        return super().all_reduce_(x, group, op)

    def all_gather_(self, parts, x, group=None):
        self.counter.all_gather_(parts, x, group)
        return super().all_gather_(parts, x, group)

    def reduce_scatter_(self, out, parts, group=None):
        self.counter.reduce_scatter_(out, parts, group)
        return super().reduce_scatter_(out, parts, group)


def record_collectives(group, mesh, fsdp, batch, seq):
    """One train step of reduced qwen3-8b on this rank of ``mesh``: the
    collectives its group saw (``CountingGroup.summary``)."""
    rec = RecordingGroup(group)
    groups = MeshGroups(rec, *mesh)
    cfg = get_config("qwen3-8b").reduced()
    shard = MeshShard(cfg, groups, fsdp=fsdp)
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   keep=shard.keep if shard.scope else None)
    shard.bind(params)
    opt_cfg = adamw.AdamWConfig()
    opt = init_opt_state(opt_cfg, params)
    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch, seed=1))
    placed = device_put_batch(data.batch_at(0), "cpu",
                              rank_rows(batch, groups.dp, groups.d))
    step = make_train_step(shard.local_cfg, opt_cfg, mesh=shard)
    step(params, opt, placed, 3e-4)
    return rec.counter.summary()
