"""Radix-tree shared-prefix KV cache: host bookkeeping of KV pages.

The counterpart of ``repro.runtime.prefix_cache``, line for line (pure
Python).  The dominant work a server recomputes is prefill over shared
prompt prefixes (system prompts, few-shot templates).  This tree is the
bookkeeping half of reusing it: a radix tree over *block-granular* KV
pages, each node owning exactly ONE block of ``block_size`` consecutive
tokens.  Child edges are keyed by the raw int32 *bytes* of the block, so
matching a P-token prefix hashes P*4 bytes instead of building P Python
ints.  A prompt's cacheable region is its full blocks (the partial tail
block is never cached); a matched path is by construction a true token
prefix and a multiple of ``block_size``.  Layouts that can alias a page
copy-on-write (paged) may also ask for a *partial* match of one more
block's leading tokens (``allow_partial``).

Lifetime rules:

* ``acquire`` pins (refcounts) every node on the matched path for a
  request's slot residency; ``release`` unpins.  Pinning keeps hot
  prefixes in the tree while in use; page *safety* is the allocator's
  job — in pooled mode every node also holds one
  :class:`~repro_torch.runtime.page_pool.PagePool` reference on its page,
  so an evicted node's page survives while block tables still alias it.
* ``extend`` inserts the prompt's not-yet-cached full blocks (allocating
  page ids, evicting if needed) and pins them; the *caller* copies the K/V
  onto the device.  ``extend_adopt`` is the zero-copy variant of the
  paged layout: the slot's own pages are adopted into the tree (an extra
  pool reference) instead of copied.
* Eviction is LRU over unpinned leaves only; freeing a leaf may expose its
  parent as the next candidate.  Pinned nodes are never evicted.

The device half (gather and scatter of pages) is in
:mod:`repro_torch.models.kvcache`; the policy half (reuse or recompute,
the layout) in the serve engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.page_pool import PagePool


def _tok_array(tokens: Sequence[int]) -> np.ndarray:
    """Canonical int32 view of a prompt (bytes-keying needs one dtype)."""
    return np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))


@dataclasses.dataclass(eq=False)  # identity semantics: nodes live in sets
class _Node:
    """One cached block: ``block_size`` tokens and their KV page id."""

    tokens: Tuple[int, ...]            # edge label (root: empty tuple)
    key: bytes                         # int32 bytes of ``tokens`` (dict key)
    block_id: int                      # page id in the device pool (-1: root)
    parent: Optional["_Node"]
    children: Dict[bytes, "_Node"] = dataclasses.field(default_factory=dict)
    refcount: int = 0                  # live requests pinning this node
    last_access: int = 0               # logical LRU clock

    @property
    def is_leaf(self) -> bool:
        return not self.children


@dataclasses.dataclass
class CacheHandle:
    """A request's pinned path through the tree (acquire → release).

    ``nodes`` is the full-block path; ``partial_node``/``partial_len``
    describe an optional partial match of ONE further block (paged
    layout only): its first ``partial_len`` tokens are a prefix of the
    query, the rest are not — the caller must copy-on-write before
    writing into that block.
    """

    nodes: List[_Node]
    matched_len: int                   # tokens served from cache at acquire
    partial_node: Optional[_Node] = None
    partial_len: int = 0

    @property
    def block_ids(self) -> List[int]:
        return [n.block_id for n in self.nodes]

    @property
    def partial_block_id(self) -> int:
        return self.partial_node.block_id if self.partial_node else -1

    @property
    def pinned_len(self) -> int:
        """Full-block tokens pinned (extend resumes from here)."""
        return sum(len(n.tokens) for n in self.nodes)


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0                      # lookups with matched_len > 0
    tokens_matched: int = 0            # cumulative matched prefix tokens
    blocks_inserted: int = 0
    blocks_adopted: int = 0            # zero-copy insertions (paged layout)
    partial_hits: int = 0              # matches that ended inside a block
    evictions: int = 0                 # blocks returned to the free list

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class PrefixCache:
    """Radix tree over refcounted, block-granular KV page ids.

    With ``pool=None`` (default) the tree owns a private free list of
    ``num_blocks`` ids, used by the contiguous KV
    layout.  With an external :class:`PagePool`, ids come from the
    shared allocator (tree ownership = one pool reference per node) so
    live block tables and cached prefixes draw from ONE pool.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 pool: Optional[PagePool] = None) -> None:
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.pool = pool
        self.root = _Node(tokens=(), key=b"", block_id=-1, parent=None)
        self._free: List[int] = [] if pool is not None else list(range(num_blocks))
        self.stats = PrefixCacheStats()
        self._clock = 0
        self._num_nodes = 0
        # incrementally maintained eviction frontier: exactly the unpinned
        # leaves.  Keeps allocation-under-pressure O(|frontier|) instead of
        # a full-tree DFS per evicted block (admission-path host work).
        self._frontier: set = set()

    @property
    def free(self) -> List[int]:
        """Standalone mode's free list (pooled mode: the pool's)."""
        return self.pool.free if self.pool is not None else self._free

    # -- clock -----------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup ----------------------------------------------------------
    def match(self, tokens: Sequence[int], *,
              max_match: Optional[int] = None) -> List[_Node]:
        """Longest cached block-path that is a prefix of ``tokens``.

        ``max_match`` caps the matched token count (the engine passes
        ``len(prompt) - 1`` so at least one token is always prefilled —
        the suffix prefill must produce first-token logits).
        """
        arr = _tok_array(tokens)
        path, _node, _pos = self._walk_full(arr, self._limit(arr, max_match))
        return path

    def _limit(self, arr: np.ndarray, max_match: Optional[int]) -> int:
        return len(arr) if max_match is None else min(len(arr), max_match)

    def _walk_full(self, arr: np.ndarray, limit: int
                   ) -> Tuple[List[_Node], _Node, int]:
        bs = self.block_size
        node, path, pos = self.root, [], 0
        while pos + bs <= limit:
            child = node.children.get(arr[pos:pos + bs].tobytes())
            if child is None:
                break
            path.append(child)
            node = child
            pos += bs
        return path, node, pos

    def _match_partial(self, node: _Node, arr: np.ndarray, pos: int,
                       limit: int) -> Tuple[Optional[_Node], int]:
        """Best child of ``node`` sharing a proper prefix of its block
        with ``arr[pos:limit]`` — the copy-on-write tail-block match."""
        want = limit - pos
        if want <= 0 or not node.children:
            return None, 0
        best, best_len = None, 0
        seg = arr[pos:limit]
        for child in node.children.values():
            lbl = np.frombuffer(child.key, dtype=np.int32)[:want]
            eq = lbl == seg[:len(lbl)]
            r = int(eq.argmin()) if not eq.all() else len(lbl)
            if r > best_len:
                best, best_len = child, r
        return best, best_len

    def probe(self, tokens: Sequence[int], *,
              max_match: Optional[int] = None) -> int:
        """Matched-prefix length WITHOUT pinning — the admission
        scheduler's cheap lookahead (full blocks only)."""
        arr = _tok_array(tokens)
        path, _n, _p = self._walk_full(arr, self._limit(arr, max_match))
        return self.block_size * len(path)

    def acquire(self, tokens: Sequence[int], *,
                max_match: Optional[int] = None,
                allow_partial: bool = False) -> CacheHandle:
        """Match and pin: refcount++ on every node of the matched path.

        ``allow_partial``: additionally match the leading tokens of ONE
        more cached block (the partially-filled tail).  Only layouts
        that can alias that block copy-on-write should ask for this —
        the contiguous layout copies whole blocks and cannot use it.
        """
        arr = _tok_array(tokens)
        limit = self._limit(arr, max_match)
        path, node, pos = self._walk_full(arr, limit)
        part, part_len = (self._match_partial(node, arr, pos, limit)
                          if allow_partial else (None, 0))
        t = self._tick()
        pinned = path if part is None else path + [part]
        for n in pinned:
            n.refcount += 1
            n.last_access = t
            self._frontier.discard(n)   # pinned -> unevictable
        matched = self.block_size * len(path) + part_len
        self.stats.lookups += 1
        if matched:
            self.stats.hits += 1
            self.stats.tokens_matched += matched
        if part_len:
            self.stats.partial_hits += 1
        return CacheHandle(nodes=list(path), matched_len=matched,
                           partial_node=part, partial_len=part_len)

    # -- insertion -------------------------------------------------------
    def extend(self, handle: CacheHandle,
               tokens: Sequence[int]) -> List[Tuple[int, int]]:
        """Cache the full blocks of ``tokens`` beyond the handle's path.

        Walks/creates children block-by-block; every visited node is
        pinned onto ``handle``.  Returns ``(block_id, token_start)`` for
        each NEWLY allocated block — the caller must fill those device
        pages before the next admission can match them.  Stops early
        (without error) when no block can be allocated even after
        eviction; partial insertion keeps the path contiguous.
        """
        return self._extend(handle, tokens, adopt_pages=None)

    def extend_adopt(self, handle: CacheHandle, tokens: Sequence[int],
                     page_of_block: Dict[int, int]) -> List[Tuple[int, int]]:
        """Zero-copy :meth:`extend` for the paged layout.

        ``page_of_block`` maps block index (``token_start //
        block_size``) to the page id the admitting slot already filled
        with that block's K/V.  Instead of allocating + copying, a new
        node *adopts* the slot's page — one extra pool reference, no
        device traffic.  Blocks another request cached concurrently are
        simply pin-walked (the slot keeps its private page).  Requires
        pooled mode.  Returns the adopted ``(block_id, token_start)``
        pairs (already filled — nothing for the caller to copy).
        """
        assert self.pool is not None, "adoption needs the shared PagePool"
        return self._extend(handle, tokens, adopt_pages=page_of_block)

    def _extend(self, handle: CacheHandle, tokens: Sequence[int],
                adopt_pages: Optional[Dict[int, int]]
                ) -> List[Tuple[int, int]]:
        arr = _tok_array(tokens)
        bs = self.block_size
        node = handle.nodes[-1] if handle.nodes else self.root
        pos = handle.pinned_len
        t = self._tick()
        fresh: List[Tuple[int, int]] = []
        while pos + bs <= len(arr):
            key = arr[pos:pos + bs].tobytes()
            child = node.children.get(key)
            if child is None:
                if adopt_pages is None:
                    bid = self._alloc()
                    if bid is None:
                        break
                    self.stats.blocks_inserted += 1
                else:
                    bid = adopt_pages.get(pos // bs)
                    if bid is None:
                        break
                    self.pool.ref(bid)          # tree becomes a co-owner
                    self.stats.blocks_adopted += 1
                child = _Node(tokens=tuple(int(x) for x in arr[pos:pos + bs]),
                              key=key, block_id=bid, parent=node)
                node.children[key] = child
                self._num_nodes += 1
                self._frontier.discard(node)  # gained a child: not a leaf
                fresh.append((bid, pos))
            child.refcount += 1
            child.last_access = t
            self._frontier.discard(child)     # pinned -> unevictable
            handle.nodes.append(child)
            node = child
            pos += bs
        return fresh

    def release(self, handle: CacheHandle) -> None:
        """Unpin a request's path (refcount--), refreshing LRU recency."""
        t = self._tick()
        pinned = list(handle.nodes)
        if handle.partial_node is not None:
            pinned.append(handle.partial_node)
        for n in pinned:
            assert n.refcount > 0, "release without matching acquire/extend"
            n.refcount -= 1
            n.last_access = t
            if n.refcount == 0 and n.is_leaf:
                self._frontier.add(n)
        handle.nodes = []
        handle.partial_node = None
        handle.partial_len = 0

    # -- eviction --------------------------------------------------------
    def _evict_one(self) -> bool:
        if not self._frontier:
            return False
        victim = min(self._frontier, key=lambda n: n.last_access)
        assert victim.refcount == 0 and victim.is_leaf, \
            "pinned or interior node on the eviction frontier"
        self._frontier.discard(victim)
        parent = victim.parent
        assert parent is not None
        del parent.children[victim.key]
        victim.parent = None
        self._num_nodes -= 1
        if self.pool is not None:
            # drop the TREE's reference only: a block table still
            # aliasing this page keeps the device data alive
            self.pool.unref(victim.block_id)
        else:
            self._free.append(victim.block_id)
        self.stats.evictions += 1
        if parent is not self.root and parent.is_leaf and parent.refcount == 0:
            self._frontier.add(parent)    # exposed as the next candidate
        return True

    def evict(self, n_blocks: int) -> int:
        """Evict up to ``n_blocks`` LRU unpinned leaves; returns count."""
        done = 0
        while done < n_blocks and self._evict_one():
            done += 1
        return done

    def _alloc(self) -> Optional[int]:
        if self.pool is not None:
            # keep evicting until a page actually FREES: in pooled mode a
            # victim's page may survive its node (a live block table still
            # aliases it — unref leaves refcount > 0), so one eviction is
            # not guaranteed to yield a free page even when later
            # evictable leaves would
            pid = self.pool.alloc()
            while pid is None and self._evict_one():
                pid = self.pool.alloc()
            return pid
        if not self._free and not self._evict_one():
            return None
        return self._free.pop()

    # -- introspection ---------------------------------------------------
    @property
    def live_blocks(self) -> int:
        """Number of blocks the TREE currently owns (pooled mode: live
        slots may hold further pages; the engine audits those)."""
        return self._num_nodes

    def total_refcount(self) -> int:
        return sum(n.refcount for n in self._walk())

    def owned_pages(self) -> List[int]:
        """Page ids owned by tree nodes (one pool reference each)."""
        return [n.block_id for n in self._walk()]

    def _walk(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def check(self) -> None:
        """Structural invariants; raises AssertionError on violation.

        * every block id is owned by exactly one node XOR (standalone
          mode) the free list; allocated + free == pool size — no leak,
          no double-free (pooled mode: refcount arithmetic is audited by
          ``PagePool.check``, which the engine feeds ALL owners);
        * refcounts are never negative;
        * every edge label has exactly ``block_size`` tokens, matches
          its child's stored tokens and its bytes key (path = true
          token prefix);
        * parent back-links are consistent;
        * the incremental eviction frontier equals the recomputed set of
          unpinned leaves.
        """
        nodes = self._walk()
        assert len(nodes) == self._num_nodes, "node counter out of sync"
        assert self._frontier == {
            n for n in nodes if n.is_leaf and n.refcount == 0}, \
            "eviction frontier out of sync with tree"
        ids = [n.block_id for n in nodes]
        assert len(ids) == len(set(ids)), "duplicate block id in tree"
        if self.pool is None:
            assert not (set(ids) & set(self._free)), "block both live and free"
            assert len(ids) + len(self._free) == self.num_blocks, (
                f"leak: {len(ids)} live + {len(self._free)} free "
                f"!= pool {self.num_blocks}")
            assert len(self._free) == len(set(self._free)), "double-free"
        for n in nodes:
            assert n.refcount >= 0, "negative refcount"
            assert len(n.tokens) == self.block_size, "partial block cached"
            assert n.key == np.asarray(n.tokens, np.int32).tobytes(), \
                "edge key out of sync with tokens"
            if self.pool is None:
                assert 0 <= n.block_id < self.num_blocks, "id out of range"
            else:
                assert self.pool.refcount(n.block_id) >= 1, \
                    "tree node holds a dead page"
            assert n.parent is not None, "orphan node reachable from root"
            assert n.parent.children.get(n.key) is n, "broken parent link"
