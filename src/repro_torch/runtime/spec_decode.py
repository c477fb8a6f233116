"""Host-side n-gram draft proposer for speculative decoding.

The port's copy of ``repro.runtime.spec_decode`` (pure host code, copied
whole).  The target model's verify pass (``models/transformer.py``,
``spec_verify_*``) is exact for ANY draft sequence — drafts only
determine how many positions of the one-pass score get committed, never
what gets committed.  That frees the proposer to be deliberately cheap:
a per-engine suffix table over the token streams the engine has already
emitted, queried by the last few tokens of each live slot.  Natural-
language (and code) generation repeats itself — locally within one
response and globally across requests that share phrasing — and an
n-gram table is the cheapest device-free way to cash that in, the same
draft model used by prompt-lookup decoding and vLLM's ``[ngram]``
speculative mode.

Design constraints, in order:

* **Zero device work.**  Drafting must not touch the accelerator; the
  whole point of speculation is to spend host time that would otherwise
  be idle while the device runs a decode step.
* **Bounded memory.**  The table is capped at ``max_entries`` contexts
  with LRU eviction — a serving process that never restarts must not
  grow its draft state without bound.  Recency is also the better
  eviction policy here: generation loops reuse *recent* context.
* **No output influence.**  The proposer sees only committed tokens and
  prompts; its drafts feed the verify pass, whose accept mask is what
  guarantees spec ≡ non-spec greedy output token-for-token.

The table maps a context tuple (the last ``order`` tokens, plus every
shorter suffix down to length 1) to the token that most recently
followed it.  Draft generation walks the chain: longest-context match
wins, then the drafted continuation extends the context for the next
position.  A miss at any point pads the remainder with ``pad_token`` —
padded positions are *wrong on purpose* (they verify-fail with
probability ~1), which keeps the accept-rate signal honest on workloads
where the table genuinely has nothing: speculation must *measure* as a
loss there so the VPE axis can back off, not get bailed out by a
hidden heuristic.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple


class NGramProposer:
    """Bounded suffix table: context tuple -> most recent next token.

    ``order``: longest context length tracked (shorter suffixes are
    tracked too, so a cold longest-order miss can still draft from a
    bigram).  The default of 8 matters more than it looks: a context
    shorter than a *run* of repeated tokens cannot tell positions
    within the run apart, so the most-recent-write rule poisons every
    earlier occurrence and replay accept collapses (measured: ~39%
    replay accept at order 3 vs ~86% at order 8 on the same streams).
    Inserts cost ``order`` dict writes per token — host-side noise
    next to a device call.  ``max_entries``: hard cap on stored
    contexts, LRU-evicted.
    """

    def __init__(self, order: int = 8, max_entries: int = 65536,
                 pad_token: int = 0) -> None:
        if order < 1:
            raise ValueError("order must be >= 1")
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.order = order
        self.max_entries = max_entries
        self.pad_token = pad_token
        # OrderedDict as LRU: updates move_to_end, eviction pops oldest
        self._table: "OrderedDict[Tuple[int, ...], int]" = OrderedDict()
        # per-slot rolling context of the last `order` committed tokens
        self._ctx: dict[int, List[int]] = {}

    def __len__(self) -> int:
        return len(self._table)

    # -- ingest ------------------------------------------------------------

    def _learn(self, ctx: Sequence[int], nxt: int) -> None:
        if nxt < 0:
            # out-of-vocab sentinel (the serve engine marks tokens from a
            # quarantined span negative): a poisoned span must never seed
            # the CROSS-request table — one bad write would replay into
            # every later request drafting through this context
            return
        for k in range(1, min(self.order, len(ctx)) + 1):
            key = tuple(ctx[-k:])
            if key in self._table:
                self._table.move_to_end(key)
            self._table[key] = int(nxt)
        while len(self._table) > self.max_entries:
            self._table.popitem(last=False)

    def observe_prompt(self, slot: int, tokens: Sequence[int]) -> None:
        """Ingest an admitted prompt and seed the slot's draft context.

        Called once per admission — prompts are where cross-request
        repetition lives (shared instructions, shared phrasing), so the
        table warms before the first decode step ever runs.
        """
        toks = [int(t) for t in tokens]
        for j in range(1, len(toks)):
            self._learn(toks[:j], toks[j])
        self._ctx[slot] = toks[-self.order:]

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        """Ingest tokens committed for ``slot`` (decode emissions)."""
        ctx = self._ctx.setdefault(slot, [])
        for t in tokens:
            if int(t) < 0:
                continue    # quarantine sentinel — see _learn
            self._learn(ctx, int(t))
            ctx.append(int(t))
            del ctx[:-self.order]

    def forget_slot(self, slot: int) -> None:
        """Drop a slot's rolling context (retire/preempt).  Table
        entries stay — they are the cross-request memory."""
        self._ctx.pop(slot, None)

    # -- draft -------------------------------------------------------------

    def draft(self, slot: int, n: int) -> List[int]:
        """Propose ``n`` candidate continuation tokens for ``slot``.

        Longest-suffix match per position; the drafted token extends
        the context for the next position so a single strong n-gram
        chain can fill the whole span.  Positions past the first miss
        are padded with ``pad_token`` (see module docstring for why a
        miss must NOT shorten the span).
        """
        ctx = list(self._ctx.get(slot, ()))
        out: List[int] = []
        for _ in range(n):
            nxt = None
            for k in range(min(self.order, len(ctx)), 0, -1):
                nxt = self._table.get(tuple(ctx[-k:]))
                if nxt is not None:
                    break
            if nxt is None:
                nxt = self.pad_token
            out.append(nxt)
            ctx.append(nxt)
            del ctx[:-self.order]
        return out
