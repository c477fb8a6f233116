"""Deterministic synthetic LM data stream.

A copy of ``repro.data.synthetic`` (pure numpy, so the two packages'
batches are identical bit for bit).  Zipf-distributed token ids
(realistic softmax/embedding access pattern), generated per (seed, step,
host) — fully deterministic and seekable, so the data cursor in a
checkpoint is just the step index and restart resumes bit-identically.
Multi-host: each process materializes only its shard of the global batch
(``process_index``/``process_count``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2


class SyntheticStream:
    def __init__(self, cfg: DataConfig, *, process_index: int = 0, process_count: int = 1):
        if cfg.global_batch % process_count:
            raise ValueError(f"global_batch={cfg.global_batch} is not a "
                             f"multiple of process_count={process_count}")
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = cfg.global_batch // process_count
        self.step = 0

    # -- cursor (checkpointable) -------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step}

    def load_state_dict(self, d: Dict) -> None:
        self.step = int(d["step"])

    # -- batch generation ---------------------------------------------
    def _rng_for(self, step: int) -> np.random.Generator:
        ss = np.random.SeedSequence(
            entropy=self.cfg.seed, spawn_key=(step, self.process_index)
        )
        return np.random.default_rng(ss)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng_for(step)
        n = self.local_batch * (self.cfg.seq_len + 1)
        # zipf, clipped into vocab; subtract 1 to include token id 0
        raw = rng.zipf(self.cfg.zipf_a, size=n).astype(np.int64) - 1
        toks = (raw % self.cfg.vocab_size).astype(np.int32)
        toks = toks.reshape(self.local_batch, self.cfg.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b
