"""Traffic from a data file and the seed.

Two general generators read the files under ``traffic/``:

* :class:`ClosedLoop` (``"driver": "serve"``): one client per slot, each
  sending its next request when its previous one completes.  Every seed
  sends the same set of sizes in another order: the prompt and output
  lengths come from a fixed deck of ``deck`` pairs at the quantiles of the
  file's distributions, and each block of ``deck`` requests is the deck in
  an order drawn from the seed.  A request's prompt is an optional shared
  system prompt (``shared_prefix``: ``count`` prompts of ``tokens`` tokens,
  one per request, each used equally often), an optional document the
  client owns (``documents``: lengths from a deck at the quantiles of the
  range, prefilled in set-up), and a unique part of the deck's length.
  Each client's first request decodes only the share ``(c + 0.5) /
  clients`` of its drawn output, so completions are spread over time from
  the start, as in a loop that has run for a while.
* :class:`TrainBatches` (``"driver": "train"``): ``batch`` rows of
  ``seq_len + 1`` tokens a step, tokens and labels shifted by one.

Token ids are Zipf-distributed, the stream of ``repro_torch.data.synthetic``
copied: ``(zipf(a) - 1) % vocab``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


def rng_for(seed: int, *key: int) -> np.random.Generator:
    entropy = [abs(int(seed)) % (1 << 128), int(seed < 0)]
    return np.random.default_rng(np.random.SeedSequence(entropy, spawn_key=key))


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int, a: float) -> np.ndarray:
    raw = rng.zipf(a, size=n).astype(np.int64) - 1
    return (raw % vocab).astype(np.int32)


def quantiles(dist: Dict, n: int) -> List[int]:
    """``n`` lengths at the mid-quantiles (i + 0.5) / n of ``dist``
    (``uniform`` or ``loguniform`` over [min, max])."""
    lo, hi = dist["min"], dist["max"]
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if dist["dist"] == "uniform":
            x = lo + u * (hi - lo)
        elif dist["dist"] == "loguniform":
            x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            raise ValueError(f"unknown length distribution {dist['dist']!r}")
        out.append(int(round(x)))
    return out


class ClosedLoop:
    """The requests of a closed-loop serving mix (module docstring)."""

    def __init__(self, traffic: Dict, vocab: int, seed: int) -> None:
        self.t = traffic
        self.vocab = vocab
        self.clients = int(traffic["clients"])
        self.a = float(traffic["zipf_a"])
        self.seed = seed
        k = int(traffic["deck"])
        prompts = quantiles(traffic["prompt"], k)
        outputs = quantiles(traffic["output"], k)
        # a fixed pairing of the two decks, the same for every seed
        pair = np.random.default_rng(0).permutation(k)
        self.deck = [(prompts[i], outputs[int(pair[i])], i) for i in range(k)]
        self._order = rng_for(seed, 1)
        self._tokens = rng_for(seed, 2)
        self._queue: List[Tuple[int, int, int]] = []
        sp = traffic.get("shared_prefix")
        self.prefixes = [zipf_tokens(self._tokens, int(sp["tokens"]), vocab, self.a)
                         for _ in range(int(sp["count"]))] if sp else []
        docs = traffic.get("documents")
        self.documents: List[np.ndarray] = []
        if docs:
            lengths = quantiles({"dist": "uniform", **docs}, self.clients)
            order = rng_for(seed, 3).permutation(self.clients)
            self.documents = [zipf_tokens(self._tokens, lengths[int(order[c])], vocab, self.a)
                              for c in range(self.clients)]
        self.sent = [0] * self.clients

    def _draw(self) -> Tuple[int, int, int]:
        if not self._queue:
            self._queue = [self.deck[int(i)] for i in self._order.permutation(len(self.deck))]
        return self._queue.pop(0)

    def next_request(self, client: int) -> Tuple[np.ndarray, int]:
        """(prompt tokens, output tokens) of ``client``'s next request."""
        plen, out, idx = self._draw()
        parts = []
        if self.prefixes:
            parts.append(self.prefixes[idx % len(self.prefixes)])
        if self.documents:
            parts.append(self.documents[client])
        parts.append(zipf_tokens(self._tokens, plen, self.vocab, self.a))
        if self.sent[client] == 0:
            out = max(1, int(round(out * (client + 0.5) / self.clients)))
        self.sent[client] += 1
        return np.concatenate(parts).astype(np.int32), out

    def warmup(self, chunk: int) -> List[Tuple[np.ndarray, int]]:
        """Set-up requests that run every prefill chunk length the mix can
        produce (each padded size up to ``chunk``, then two chunks) behind
        every shared prefix and document, and put the prefixes and
        documents into the prefix cache."""
        sizes, n = [], 16
        while n < chunk:
            sizes.append(n)
            n *= 2
        sizes += [chunk, chunk + 16]
        heads = self.prefixes or [np.zeros(0, np.int32)]
        out = []
        for h, head in enumerate(heads):
            for s in sizes:
                tail = zipf_tokens(self._tokens, s, self.vocab, self.a)
                out.append((np.concatenate([head, tail]).astype(np.int32), 2))
        for doc in self.documents:
            out.append((doc, 1))
        return out


class TrainBatches:
    """Training batches: ``batch_at(step)`` -> {"tokens", "labels"}."""

    def __init__(self, traffic: Dict, vocab: int, seed: int) -> None:
        self.batch = int(traffic["batch"])
        self.seq = int(traffic["seq_len"])
        self.a = float(traffic["zipf_a"])
        self.vocab = vocab
        self.seed = seed
        self.step = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = rng_for(self.seed, 4, step)
        toks = zipf_tokens(rng, self.batch * (self.seq + 1), self.vocab, self.a)
        toks = toks.reshape(self.batch, self.seq + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b
