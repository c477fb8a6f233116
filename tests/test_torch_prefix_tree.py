"""Property-based tests (hypothesis) of the port's radix-tree prefix cache,
after tests/test_prefix_tree.py, plus one cross-package check.

The tree is host bookkeeping only, so random acquire/extend/release/evict
sequences are cheap.  After every operation: refcounts never go negative,
pinned blocks are never evicted, a matched prefix is a true token prefix
and a multiple of ``block_size``, and allocated + free == pool size.  The
cross-package test drives ``repro_torch.runtime.prefix_cache`` and
``repro.runtime.prefix_cache`` with one seeded sequence — standalone and
over a shared page pool, with partial matches — and requires equal matched
lengths, block ids, inserted blocks, evictions and audits.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.runtime import page_pool as jpool  # noqa: E402
from repro.runtime import prefix_cache as jpc  # noqa: E402
from repro_torch.runtime import page_pool as tpool  # noqa: E402
from repro_torch.runtime.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.runtime import prefix_cache as tpc  # noqa: E402

settings.register_profile("ci", max_examples=40, deadline=None)
settings.load_profile("ci")

BS = 4  # small block size so short random prompts still share blocks

# tiny alphabet + short lengths force heavy prefix collisions
prompts = st.lists(st.integers(0, 2), min_size=1, max_size=18)


def token_path(handle):
    out = []
    for n in handle.nodes:
        out.extend(n.tokens)
    return out


class TestMatchIsTruePrefix:
    @given(st.lists(prompts, min_size=1, max_size=8))
    def test_match_returns_token_prefix(self, batch):
        # no insert can evict: 8 prompts x <= 4 full blocks fit
        cache = PrefixCache(num_blocks=64, block_size=BS)
        for toks in batch:
            h = cache.acquire(toks)
            cache.extend(h, toks)
            cache.release(h)
            cache.check()
        for toks in batch:
            h = cache.acquire(toks)
            assert h.matched_len % BS == 0
            assert h.matched_len <= len(toks)
            assert token_path(h) == [int(t) for t in toks[:h.matched_len]]
            # every full block of a previously inserted prompt must hit
            assert h.matched_len == (len(toks) // BS) * BS
            cache.release(h)
            cache.check()

    @given(prompts, st.integers(0, 18))
    def test_max_match_cap_respected(self, toks, cap):
        cache = PrefixCache(num_blocks=16, block_size=BS)
        h = cache.acquire(toks)
        cache.extend(h, toks)
        cache.release(h)
        h2 = cache.acquire(toks, max_match=cap)
        assert h2.matched_len <= cap
        assert h2.matched_len % BS == 0
        cache.release(h2)
        cache.check()


class TestRandomSoakSequences:
    @given(st.data())
    def test_invariants_under_random_ops(self, data):
        cache = PrefixCache(num_blocks=8, block_size=BS)
        held = []
        n_ops = data.draw(st.integers(1, 40), label="n_ops")
        for _ in range(n_ops):
            op = data.draw(st.sampled_from(
                ["acquire", "extend", "release", "evict"]), label="op")
            if op == "acquire":
                toks = data.draw(prompts, label="toks")
                held.append((cache.acquire(toks), toks))
            elif op == "extend" and held:
                h, toks = held[data.draw(
                    st.integers(0, len(held) - 1), label="which")]
                cache.extend(h, toks)
            elif op == "release" and held:
                idx = data.draw(st.integers(0, len(held) - 1), label="rel")
                h, _ = held.pop(idx)
                cache.release(h)
            elif op == "evict":
                cache.evict(data.draw(st.integers(1, 8), label="n_evict"))
            cache.check()
            assert cache.live_blocks <= cache.num_blocks
            for h, _ in held:
                assert not (set(h.block_ids) & set(cache.free)), \
                    "pinned block was evicted/freed"
        for h, _ in held:
            cache.release(h)
        cache.check()
        assert cache.total_refcount() == 0
        # with zero pins everything is evictable: a full drain leaks nothing
        cache.evict(cache.num_blocks + 1)
        assert cache.live_blocks == 0
        assert sorted(cache.free) == list(range(cache.num_blocks))

    @given(st.lists(prompts, min_size=1, max_size=6))
    def test_pinned_survive_full_eviction(self, batch):
        cache = PrefixCache(num_blocks=32, block_size=BS)
        first = batch[0]
        h0 = cache.acquire(first)
        cache.extend(h0, first)
        for toks in batch[1:]:
            h = cache.acquire(toks)
            cache.extend(h, toks)
            cache.release(h)
        pinned_ids = set(h0.block_ids)
        cache.evict(cache.num_blocks + 1)
        cache.check()
        # the pinned path is intact: a re-match still finds it
        h1 = cache.acquire(first, max_match=len(h0.nodes) * BS)
        assert set(h1.block_ids) == pinned_ids
        cache.release(h0)
        cache.release(h1)
        cache.check()
        assert cache.total_refcount() == 0


class TestPoolExhaustion:
    @given(st.lists(prompts, min_size=1, max_size=10))
    def test_never_exceeds_pool_and_degrades_gracefully(self, batch):
        cache = PrefixCache(num_blocks=2, block_size=BS)  # starved pool
        for toks in batch:
            h = cache.acquire(toks)
            fresh = cache.extend(h, toks)  # may insert 0..2 blocks
            assert len(fresh) <= cache.num_blocks
            cache.check()
            cache.release(h)
        cache.check()
        assert cache.live_blocks <= 2


def _audit(cache):
    try:
        cache.check()
        return "ok"
    except AssertionError as e:
        return f"failed: {e}"


@pytest.mark.parametrize("pooled", [False, True], ids=["standalone", "pooled"])
def test_same_sequence_same_tree_as_reference(pooled):
    """One seeded sequence of 400 acquire (with and without partial
    matches) / extend / extend_adopt / release / evict operations on both
    packages' trees: every result and every audit is equal."""
    rng = np.random.default_rng(17)
    trees = []
    for pc, pp in ((tpc, tpool), (jpc, jpool)):
        pool = pp.PagePool(12) if pooled else None
        trees.append((pc.PrefixCache(12, BS, pool=pool), pool))
    held = []                        # [(torch handle, jax handle, tokens)]
    log = []                         # (what, port's result, reference's)
    hits = 0
    for _ in range(400):
        op = rng.choice(["acquire", "extend", "release", "evict"],
                        p=[0.35, 0.3, 0.25, 0.1])
        if op == "acquire":
            toks = rng.integers(0, 3, int(rng.integers(1, 19))).astype(np.int32)
            cap = int(rng.integers(0, 20)) if rng.random() < 0.3 else None
            partial = bool(pooled and rng.random() < 0.5)
            hs = [t.acquire(toks, max_match=cap, allow_partial=partial)
                  for t, _ in trees]
            held.append((*hs, toks))
            log.append(("acquire", *[(h.matched_len, h.block_ids,
                                      h.partial_block_id, h.partial_len)
                                     for h in hs]))
            hits += hs[0].matched_len > 0
        elif op == "extend" and held:
            *hs, toks = held[int(rng.integers(len(held)))]
            if pooled and rng.random() < 0.5:
                # adoption: each package's own pool pages stand in for a
                # slot's block table (allocated in the same order)
                pages = [p.alloc() for _, p in trees]
                if None in pages:
                    continue
                res = [t.extend_adopt(h, toks, {len(h.nodes): pid})
                       for (t, _), h, pid in zip(trees, hs, pages)]
                for (_, p), pid in zip(trees, pages):
                    p.unref(pid)         # the tree's reference keeps it
            else:
                res = [t.extend(h, toks) for (t, _), h in zip(trees, hs)]
            log.append(("extend", *res))
        elif op == "release" and held:
            *hs, _ = held.pop(int(rng.integers(len(held))))
            for (t, _), h in zip(trees, hs):
                t.release(h)
        elif op == "evict":
            n = int(rng.integers(1, 4))
            log.append(("evict", *[t.evict(n) for t, _ in trees]))
        log.append(("check", *[_audit(t) for t, _ in trees]))
        log.append(("state", *[(sorted(t.owned_pages()), t.live_blocks,
                                t.total_refcount(), sorted(t.free))
                               for t, _ in trees]))
    for what, port, ref in log:
        assert port == ref, (what, port, ref)
        if what == "check":
            assert port == "ok"
    assert hits > 5 and any(w == "extend" and p for w, p, _ in log)
