"""KV-pool sanitizer: the census of page state at every step boundary.

Port of the census half of ``repro.kvcache.sanitize``. With
``LocalDisaggEngine(..., sanitize=True)`` the scheduler calls
``PoolSanitizer.check_step`` after every step and it checks:

- pool conservation: every page id is in exactly one of FREE / CACHED /
  ACTIVE / SWAPPED, and the populations sum to the pool's capacity;
- the swap tier: the SWAPPED population equals exactly the pages the
  preemption subsystem's swap records claim are still device-resident (a
  leaked swapped page is diagnosed naming the swap tier as holder class);
- refcounts: for every page, the pool's refcount equals the number of
  holders the engine's own structures claim: prefill sessions'
  allocations, in-flight chunked requests (their allocation, or the
  sibling pin), decode sequences' shared and private block tables, and the
  shared prefix of a sequence parked in the swap tier;
- sentinel hygiene: page 0 (the never-allocated padding sentinel) appears
  in no live block table;
- radix <-> pool: every block the prefix index can serve a match from is
  resident (active or cached), never free or swapped, RELAY-published pages
  (decode-written KV adopted into the tree at finish) included: they sit at
  refcount 0 (CACHED) unless a live holder references them, and a leaked
  ACTIVE relay page is diagnosed by name.

The reference's other half, donation poisoning (``_PoisonedBuffer``,
``SanitizedKVPool``), has no counterpart here: it traps reads through a
pool buffer handed out before a DONATED update retired it, and the port
donates nothing. Its pool is updated in place (the decode step,
``copy_page``, the swap tier's restore), and it has no
``decode_state``/``absorb_decode_state`` pair whose stale half could be
read.

Checks never mutate pool or engine state and run on the host, so a
``sanitize=True`` run is token-identical to ``sanitize=False``.
"""
from __future__ import annotations


class SanitizerError(AssertionError):
    """A serving invariant was violated (diagnostics in the message)."""


def _fail(msg: str):
    raise SanitizerError(msg)


# ----------------------------------------------------------------------
# standalone checkers (usable from property tests without an engine)
# ----------------------------------------------------------------------

def check_pool(pool) -> None:
    """Raising version of ``BlockPool.check_invariants`` with precise
    diagnostics: every page in exactly one state, populations conserved."""
    free = set(pool._free)
    cached = set(pool._cached)
    swapped = set(pool._swapped)
    if len(free) != len(pool._free):
        _fail(f"pool free list holds duplicate ids: {sorted(pool._free)}")
    both = free & cached
    if both:
        _fail(f"pages {sorted(both)} are simultaneously FREE and CACHED")
    overlap = swapped & (free | cached)
    if overlap:
        _fail(f"pages {sorted(overlap)} are SWAPPED but also in the "
              f"free/cached population: swap-out must remove the page "
              f"from every other state")
    if pool.SENTINEL in free or pool.SENTINEL in cached:
        _fail("sentinel page 0 entered the free/cached population: "
              "something allocated or released the padding page")
    if pool.SENTINEL in swapped:
        _fail("sentinel page 0 entered the SWAPPED population: the "
              "padding page holds no KV to swap")
    active = 0
    for bid in range(1, pool.num_blocks + 1):
        rc = pool._refcount[bid]
        if rc < 0:
            _fail(f"page {bid} refcount is negative ({rc}): over-released")
        in_free, in_cached = bid in free, bid in cached
        in_swapped = bid in swapped
        if rc > 0:
            if in_free or in_cached or in_swapped:
                state = ("free" if in_free
                         else "cached" if in_cached else "swapped")
                _fail(f"page {bid} is ACTIVE (refcount {rc}) but also in "
                      f"the {state} population")
            active += 1
        elif not (in_free or in_cached or in_swapped):
            _fail(f"page {bid} is in no state: refcount 0, not free, "
                  f"not cached, not swapped (leaked out of the pool)")
    if len(free) + len(cached) + len(swapped) + active != pool.num_blocks:
        _fail(f"pool conservation broken: {len(free)} free + {len(cached)} "
              f"cached + {len(swapped)} swapped + {active} active != "
              f"{pool.num_blocks} total")
    if pool._refcount[pool.SENTINEL] != 0:
        _fail(f"sentinel page 0 has refcount "
              f"{pool._refcount[pool.SENTINEL]}: it must never be held")


def check_index(index, pool=None) -> None:
    """Radix-tree structural invariants, plus (with ``pool``) residency:
    every block the index can serve a match from must be active or cached,
    never free (its KV is about to be overwritten) nor swapped."""
    if index is None or not hasattr(index, "_by_block"):
        return                       # NullPrefixIndex / disabled
    for bid, node in index._by_block.items():
        if node.block_id != bid:
            _fail(f"index entry for block {bid} points at node carrying "
                  f"block {node.block_id}")
        if node.parent is None:
            _fail(f"index node for block {bid} has no parent (detached "
                  f"from the tree but still matchable)")
        if node.parent.children.get(node.key) is not node:
            _fail(f"index node for block {bid} is not linked from its "
                  f"parent: match() and _by_block disagree")
        p = node.parent
        while p is not index.root:
            if p.block_id not in index._by_block:
                _fail(f"block {bid} has unregistered ancestor block "
                      f"{p.block_id}: an orphan chain survived eviction")
            p = p.parent
        if pool is not None:
            if bid == pool.SENTINEL:
                _fail("prefix index holds the sentinel page 0")
            if bid in pool._swapped:
                _fail(f"prefix index can serve block {bid} but the pool "
                      f"has it SWAPPED: its KV lives in the host swap "
                      f"tier and the device row is revocable")
            if pool._refcount[bid] == 0 and bid not in pool._cached:
                _fail(f"prefix index can serve block {bid} but the pool "
                      f"has it FREE: matches would alias recycled KV")


# ----------------------------------------------------------------------
# engine-level step-boundary checker
# ----------------------------------------------------------------------

class PoolSanitizer:
    """Cross-checks the pool's refcounts against the holders the engine's
    own structures claim, at every scheduler step boundary."""

    def __init__(self, engine):
        self.engine = engine
        self.checks = 0          # step boundaries validated

    # -- holder census --------------------------------------------------
    def _relay_published(self) -> set[int]:
        """Page ids the radix tree serves from RELAY provenance. A published
        page is unref'd to CACHED in the same ``_finish`` that adopted it,
        so relay adds a page lifecycle, not a holder class; the set exists
        so a violation NAMES the relay page as such."""
        idx = self.engine.prefix_index
        if not hasattr(idx, "_by_block"):
            return set()
        return {bid for bid, nd in idx._by_block.items()
                if nd.provenance == "relay"}

    def _expected_refcounts(self) -> dict[int, list[str]]:
        """page id -> one holder description per expected reference, from
        prefill sessions, in-flight chunked requests, active decode
        sequences and parked (swapped) sequences' shared prefixes."""
        eng = self.engine
        holders: dict[int, list[str]] = {}

        def hold(bid: int, who: str):
            holders.setdefault(bid, []).append(who)

        seen_allocs: set[int] = set()
        for w in eng.prefill_workers:
            for sid, sc in w.sessions.items():
                if id(sc.alloc) in seen_allocs:
                    continue
                seen_allocs.add(id(sc.alloc))
                for bid in sc.alloc.blocks:
                    hold(bid, f"session {sid} (worker {w.wid})")
        sched = eng.scheduler
        for r in sched.prefilling:
            if r.sibling_bt is not None:
                for bid in r.sibling_bt:
                    hold(bid, f"request {r.rid} sibling pin")
            elif r.alloc is not None and id(r.alloc) not in seen_allocs:
                # after _commit_request the SAME Allocation lives in the
                # session (counted above): count it once
                seen_allocs.add(id(r.alloc))
                for bid in r.alloc.blocks:
                    hold(bid, f"request {r.rid} in-flight allocation")
        for s in sched.active:
            for bid in s.shared_blocks:
                hold(bid, f"decode seq rid={s.rid} shared")
            for bid in s.private_blocks:
                hold(bid, f"decode seq rid={s.rid} private")
        if eng.swap is not None:
            # a parked sequence keeps its cached-prefix refs: only its
            # PRIVATE pages moved to the swap tier (refcount 0, SWAPPED,
            # censused by _check_swap_tier)
            for rid, rec in eng.swap.records.items():
                for bid in rec.seq.shared_blocks:
                    hold(bid, f"swapped seq rid={rid} shared (swap tier)")
        return holders

    # -- checks ----------------------------------------------------------
    def _live_tables(self):
        eng = self.engine
        for w in eng.prefill_workers:
            for sid, sc in w.sessions.items():
                yield f"session {sid} (worker {w.wid})", sc.block_table
        for r in eng.scheduler.prefilling:
            if r.sibling_bt is not None:
                yield f"request {r.rid} sibling table", r.sibling_bt
            elif r.block_table:
                yield f"request {r.rid} prefill table", r.block_table
        for s in eng.scheduler.active:
            yield f"decode seq rid={s.rid}", s.block_table

    def _check_swap_tier(self, pool) -> None:
        """The SWAPPED population must be exactly the pages the swap tier's
        records claim are still device-resident: a SWAPPED page with no
        owning record leaked (its host copy is unreachable), and a record
        claiming residency the pool disavows would restore onto a row that
        belongs to someone else."""
        swap = self.engine.swap
        claimed: dict[int, int] = {}            # bid -> rid
        if swap is not None:
            for rid, rec in swap.records.items():
                for bid in rec.resident:
                    if bid in claimed:
                        _fail(f"page {bid} is claimed swap-resident by BOTH "
                              f"rid={claimed[bid]} and rid={rid}")
                    claimed[bid] = rid
        for bid in sorted(pool._swapped):
            if bid not in claimed:
                _fail(f"page {bid} is SWAPPED in the pool but NO swap "
                      f"record owns its host copy: holder: swap tier "
                      f"(preempted sequence KV parked in host memory); a "
                      f"swap_out without a matching HostSwapPool entry "
                      f"leaks the page")
        for bid, rid in sorted(claimed.items()):
            if bid not in pool._swapped:
                _fail(f"swap record rid={rid} claims page {bid} is still "
                      f"device-resident but the pool does not have it "
                      f"SWAPPED: a restore would overwrite a row owned by "
                      f"someone else")

    def check_step(self) -> None:
        eng = self.engine
        pool = eng.block_pool
        check_pool(pool)
        check_index(eng.prefix_index, pool)
        for who, bt in self._live_tables():
            if pool.SENTINEL in bt:
                _fail(f"sentinel page 0 appears in the live block table of "
                      f"{who}: {bt}: padding leaked into ownership")
        self._check_swap_tier(pool)
        holders = self._expected_refcounts()
        relay = self._relay_published()
        for bid, who in sorted(holders.items()):
            rc = pool._refcount[bid]
            if rc != len(who):
                tag = " [relay-published page]" if bid in relay else ""
                _fail(f"refcount mismatch on page {bid}{tag}: pool says "
                      f"{rc}, engine structures hold {len(who)} "
                      f"reference(s) ({'; '.join(who)})")
        for bid in range(1, pool.num_blocks + 1):
            rc = pool._refcount[bid]
            if rc > 0 and bid not in holders:
                if bid in relay:
                    _fail(f"page {bid} is ACTIVE (refcount {rc}) but NO "
                          f"engine structure holds it: holder: relay "
                          f"publication (decode-written page adopted by the "
                          f"radix tree at finish); _finish/_relay_publish "
                          f"must unref adopted pages to CACHED, so an "
                          f"ACTIVE holderless relay page is a leaked "
                          f"reference")
                _fail(f"page {bid} is ACTIVE (refcount {rc}) but NO engine "
                      f"structure holds it: a leaked reference (missing "
                      f"unref/drop on some exit path)")
        self.checks += 1
