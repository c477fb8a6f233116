"""Unified KV page allocator — one refcounted id space for tree + slots.

In the paged KV layout live slots reference pages *directly* through
block tables, so a page can be kept alive by several owners at once:

* the radix tree (one reference per tree node that owns the page),
* any number of live slots whose block tables alias it (zero-copy
  prefix admission), including the slot that originally computed it
  (zero-copy adoption of a cold prompt's blocks into the tree).

This module is that shared ownership, host-side only: an explicit
per-page reference count plus a free list.  A page returns to the free
list exactly when its count hits zero — the tree evicting a node while
a slot still aliases the page merely drops the tree's reference; the
device page stays valid until the slot retires.  (Safety therefore does
NOT depend on pinning; pinning remains a *policy* device that keeps hot
prefixes resident in the tree while requests using them are live.)

The pool never touches device memory.  The device arrays behind the ids
live in :mod:`repro_torch.models.kvcache` (``init_page_pool`` allocates one
extra "trash" row at index ``num_pages``: free slots' garbage decode
writes are redirected there, so the trash id is deliberately OUTSIDE
this allocator's id space and can never be allocated, referenced, or
freed).
"""

from __future__ import annotations

from typing import Dict, List, Optional


class PagePool:
    """Refcounted free-list allocator over page ids ``[0, num_pages)``."""

    def __init__(self, num_pages: int) -> None:
        if num_pages <= 0:
            raise ValueError("num_pages must be positive")
        self.num_pages = num_pages
        self.free: List[int] = list(range(num_pages))
        self.refs: List[int] = [0] * num_pages
        self.allocs = 0          # lifetime counters (bench/stats)
        self.frees = 0
        self.swap_outs = 0       # preemption swaps (events, not pages)
        self.swap_ins = 0

    @property
    def trash_id(self) -> int:
        """Id of the device-side garbage row (outside the allocatable
        pool — see module docstring)."""
        return self.num_pages

    @property
    def num_free(self) -> int:
        return len(self.free)

    @property
    def num_live(self) -> int:
        return self.num_pages - len(self.free)

    @property
    def drained(self) -> bool:
        """True when every page is back on the free list — the zero-leak
        endpoint of a run whose prefix cache has also been cleared.
        While a prefix cache still owns nodes this is legitimately
        False; the owner-exact audit for that state is :meth:`check`
        with an ``owners`` map (the engine's ``check_kv``).  Chaos runs
        assert the owner-exact audit after every recovery and use this
        as the final hard stop after a full drain + cache drop."""
        return len(self.free) == self.num_pages

    def alloc(self) -> Optional[int]:
        """Take a page off the free list with refcount 1, or None."""
        if not self.free:
            return None
        pid = self.free.pop()
        assert self.refs[pid] == 0, "free page with live refs"
        self.refs[pid] = 1
        self.allocs += 1
        return pid

    def ref(self, pid: int) -> None:
        """Add an owner to a live page (alias / adoption)."""
        assert 0 <= pid < self.num_pages, f"page id {pid} out of range"
        assert self.refs[pid] > 0, f"ref of dead page {pid}"
        self.refs[pid] += 1

    def unref(self, pid: int) -> None:
        """Drop one owner; the page is freed when the count reaches 0."""
        assert 0 <= pid < self.num_pages, f"page id {pid} out of range"
        assert self.refs[pid] > 0, f"unref of dead page {pid}"
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            self.free.append(pid)
            self.frees += 1

    def refcount(self, pid: int) -> int:
        return self.refs[pid]

    # -- preemption swap -------------------------------------------------
    def swap_out(self, pids: List[int]) -> int:
        """Release a preempted slot's references after its page CONTENT
        was gathered to host memory (:func:`repro_torch.models.kvcache.
        swap_out_pages` does the device half; this is the accounting
        half).  One reference per page is dropped — a page still aliased
        by the prefix tree or another slot survives; private pages
        return to the free list.  Returns the number of pages actually
        freed."""
        freed = 0
        for pid in pids:
            self.unref(pid)
            if self.refs[pid] == 0:
                freed += 1
        self.swap_outs += 1
        return freed

    def swap_in(self, n: int) -> Optional[List[int]]:
        """Atomically allocate ``n`` fresh pages for a swapped-out
        residency to scatter its host K/V back into — all or none, so a
        half-satisfied swap-in can never leak pages (the engine falls
        back to its eviction/preemption escalation when this returns
        None)."""
        if len(self.free) < n:
            return None
        pids = [self.alloc() for _ in range(n)]
        self.swap_ins += 1
        return pids

    def check(self, owners: Optional[Dict[int, int]] = None) -> None:
        """Free-list + refcount audit; raises AssertionError on violation.

        * every page is free (ref 0) XOR live (ref > 0) — no page is
          both, none is neither, ids never leave ``[0, num_pages)``;
        * the free list holds no duplicates;
        * when ``owners`` is given — a map ``page id -> expected owner
          count`` built by the caller from ALL owning structures (tree
          nodes + live block tables) — the pool's refcounts must equal
          it exactly: a ref the owners can't account for is a leak, a
          missing ref is a use-after-free waiting to happen.
        """
        assert len(self.free) == len(set(self.free)), "double-free"
        for pid in self.free:
            assert 0 <= pid < self.num_pages, "free id out of range"
            assert self.refs[pid] == 0, f"page {pid} free with refs"
        free = set(self.free)
        for pid, r in enumerate(self.refs):
            assert r >= 0, f"negative refcount on page {pid}"
            assert (r == 0) == (pid in free), (
                f"page {pid}: refs={r} but "
                f"{'on' if pid in free else 'missing from'} free list")
        if owners is not None:
            for pid in owners:
                assert 0 <= pid < self.num_pages, (
                    f"owned page {pid} outside pool")
            for pid, r in enumerate(self.refs):
                want = owners.get(pid, 0)
                assert r == want, (
                    f"page {pid}: pool refcount {r} != {want} owners "
                    f"(leak or dangling reference)")
