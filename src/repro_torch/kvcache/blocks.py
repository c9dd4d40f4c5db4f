"""Paged KV block pool: refcounted physical pages with LRU reuse.

The control plane of PagedAttention adapted for the shared-prefill setting:
physical pages hold KV produced by the *base* model, so the same page can be
referenced by requests headed to different decode models. Pages move through
states: FREE -> ACTIVE (refcount > 0) -> CACHED (refcount 0, retained for
prefix reuse, LRU-evictable) -> FREE.

A fourth state backs oversubscription (serving/preempt.py): SWAPPED — the
page's KV lives in a host-memory swap tier, the device row is reclaimable.
``swap_out`` moves a sole-holder ACTIVE page to SWAPPED; ``alloc`` may
revoke a SWAPPED page (its host copy stays valid, so the swap tier is
as-good-as-free capacity — revocation fires a callback so the tier knows
the device row is gone); ``reclaim_swapped`` resumes a still-resident page
in place with zero data movement; ``discard_swapped`` frees on abort.

Page id 0 is the PADDING SENTINEL: it is never allocated, so every ragged
block table zero-padded to a common width (batched decode steps, chunked
prefill, the fused multi-model plane's fake batch rows) aliases a page that
holds no live KV by construction. Usable ids are 1..num_blocks; ``num_blocks``
remains the usable capacity.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass


class PoolExhausted(Exception):
    pass


@dataclass
class PoolStats:
    allocs: int = 0
    evictions: int = 0
    peak_used: int = 0


class BlockPool:
    #: page id reserved as the never-allocated block-table padding sentinel
    SENTINEL = 0

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks          # usable capacity: ids 1..num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks, 0, -1))
        self._refcount = [0] * (num_blocks + 1)
        self._cached = OrderedDict()          # block_id -> None, LRU order
        self._swapped = set()                 # KV in the host swap tier
        self._evict_cbs = []                  # notify indexes on eviction
        self._swap_reclaim_cbs = []           # notify swap tier on revocation
        self.stats = PoolStats()

    # ------------------------------------------------------------------
    def add_evict_callback(self, cb):
        """Register an additional eviction listener.

        A pool shared by several CacheManagers must notify EVERY registered
        index when a physical page is reclaimed — any of them may hold a
        node for it. With the engine-global radix tree there is one shared
        index (registered once, by the engine); per-manager private indexes
        (simulator baseline mode) each register their own. Either way a
        callback fires BEFORE the page re-enters the free list, so no index
        can serve a match for a page whose KV is about to be overwritten."""
        self._evict_cbs.append(cb)

    def add_swap_reclaim_callback(self, cb):
        """Register a listener fired when ``alloc`` revokes a SWAPPED page.

        The swap tier (kvcache/swap.py) registers here: a revoked page's
        device row now belongs to a new owner, so the tier must mark the
        victim's page non-resident and restore it from the host copy on
        resume. The callback fires BEFORE the page is handed out."""
        self._swap_reclaim_cbs.append(cb)

    @property
    def free_count(self) -> int:
        # SWAPPED pages count as free capacity: their KV is safe on the host,
        # so the device rows are reclaimable on demand (revocation callback).
        return len(self._free) + len(self._swapped) + len(self._cached)

    @property
    def cached_count(self) -> int:
        """Pages retained at refcount 0 for prefix reuse (LRU-evictable)."""
        return len(self._cached)

    @property
    def swapped_count(self) -> int:
        """Pages whose KV lives in the host swap tier (device row reclaimable)."""
        return len(self._swapped)

    @property
    def active_count(self) -> int:
        return self.num_blocks - self.free_count

    def alloc(self, n: int) -> list[int]:
        """Allocate n fresh blocks (refcount=1), evicting LRU cached blocks
        if the free list runs dry."""
        if n > self.free_count:
            raise PoolExhausted(f"need {n}, have {self.free_count}")
        out = []
        for _ in range(n):
            if not self._free:
                if self._swapped:
                    # revoke a swapped page's device row: its KV is safe in
                    # the host tier, the CACHED prefix KV would be lost —
                    # so swapped rows are reclaimed before LRU eviction
                    bid = self._swapped.pop()
                    for cb in self._swap_reclaim_cbs:
                        cb(bid)
                else:
                    bid, _ = self._cached.popitem(last=False)  # LRU
                    self.stats.evictions += 1
                    for cb in self._evict_cbs:
                        cb(bid)
                self._free.append(bid)
            bid = self._free.pop()
            self._refcount[bid] = 1
            out.append(bid)
        self.stats.allocs += n
        self.stats.peak_used = max(self.stats.peak_used, self.active_count)
        return out

    def ref(self, block_ids) -> None:
        """Take a reference on existing blocks (prefix-cache hit)."""
        for bid in block_ids:
            if bid == self.SENTINEL:
                raise ValueError("page 0 is the padding sentinel, never live")
            if bid in self._swapped:
                raise ValueError(
                    f"block {bid} is SWAPPED (KV in the host tier); "
                    f"reclaim_swapped it, do not ref")
            if self._refcount[bid] == 0:
                if bid not in self._cached:
                    raise ValueError(f"block {bid} is free, cannot ref")
                del self._cached[bid]
            self._refcount[bid] += 1

    def unref(self, block_ids) -> None:
        """Drop a reference; refcount-0 blocks become CACHED (LRU-retained)."""
        for bid in block_ids:
            if bid == self.SENTINEL:
                raise ValueError("page 0 is the padding sentinel, never live")
            rc = self._refcount[bid]
            if rc <= 0:
                raise ValueError(f"block {bid} not active")
            self._refcount[bid] = rc - 1
            if rc == 1:
                self._cached[bid] = None
                self._cached.move_to_end(bid)

    def touch(self, block_ids) -> None:
        """Refresh LRU position of cached blocks (on prefix hit)."""
        for bid in block_ids:
            if bid in self._cached:
                self._cached.move_to_end(bid)

    def drop(self, block_ids) -> None:
        """Hard-free blocks (invalidated, e.g. schema mismatch)."""
        for bid in block_ids:
            if bid == self.SENTINEL:
                raise ValueError("page 0 is the padding sentinel, never live")
            if bid in self._swapped:
                raise ValueError(
                    f"block {bid} is SWAPPED; use discard_swapped")
            if bid in self._cached:
                del self._cached[bid]
            self._refcount[bid] = 0
            self._free.append(bid)

    # ------------------------------------------------------------------
    # swap tier (oversubscription: serving/preempt.py owns the lifecycle)
    # ------------------------------------------------------------------
    def swap_out(self, block_ids) -> None:
        """ACTIVE -> SWAPPED: the caller has copied these pages' KV to the
        host tier and relinquishes the device rows. Only sole-holder pages
        may swap (refcount must be exactly 1 — a shared page's other holders
        would read a revoked row)."""
        for bid in block_ids:
            if bid == self.SENTINEL:
                raise ValueError("page 0 is the padding sentinel, never live")
            rc = self._refcount[bid]
            if rc != 1:
                raise ValueError(
                    f"block {bid} has refcount {rc}, only sole-holder "
                    f"(refcount 1) pages may swap out")
            self._refcount[bid] = 0
            self._swapped.add(bid)

    def reclaim_swapped(self, block_ids) -> None:
        """SWAPPED -> ACTIVE in place: the device row was never revoked, so
        the resuming sequence reattaches with zero data movement."""
        for bid in block_ids:
            if bid not in self._swapped:
                raise ValueError(f"block {bid} is not swapped")
            self._swapped.discard(bid)
            self._refcount[bid] = 1

    def discard_swapped(self, block_ids) -> None:
        """SWAPPED -> FREE: the parked sequence was aborted, its host copy
        is being dropped and the device rows return to the pool."""
        for bid in block_ids:
            if bid not in self._swapped:
                raise ValueError(f"block {bid} is not swapped")
            self._swapped.discard(bid)
            self._free.append(bid)

    def refcount(self, bid: int) -> int:
        return self._refcount[bid]

    def check_invariants(self) -> None:
        """Property-test hook: every block is in exactly one state."""
        free = set(self._free)
        cached = set(self._cached)
        swapped = set(self._swapped)
        assert not (free & cached), "block both free and cached"
        assert not (swapped & (free | cached)), \
            "swapped block also free or cached"
        assert self.SENTINEL not in free and self.SENTINEL not in cached \
            and self.SENTINEL not in swapped, "sentinel page 0 entered the pool"
        assert self._refcount[self.SENTINEL] == 0, "sentinel page 0 is live"
        for bid in range(1, self.num_blocks + 1):
            rc = self._refcount[bid]
            if bid in free:
                assert rc == 0, f"free block {bid} has refcount {rc}"
            elif bid in cached:
                assert rc == 0, f"cached block {bid} has refcount {rc}"
            elif bid in swapped:
                assert rc == 0, f"swapped block {bid} has refcount {rc}"
            else:
                assert rc > 0, f"active block {bid} has refcount {rc}"
        assert len(free) + len(cached) + len(swapped) + sum(
            1 for r in self._refcount if r > 0) == self.num_blocks
