"""Priority preemption: oversubscribe the pool, evict decodes, not admissions.

Port of ``repro.serving.preempt``. Without preemption, pool pressure can
only HOLD new work (the scheduler's backpressure), so a burst of long
low-priority decodes starves high-priority traffic. With it:

  swap-out      the victim's PRIVATE pages (copy-on-write tail and
                generated KV, which nobody else can reference) move to the
                host tier (``kvcache/swap.py``: a gather per pool tensor
                into pinned memory, timed); the device rows become the
                pool's SWAPPED state (as good as free: ``alloc`` may revoke
                them) and the sequence parks. On resume, never-revoked rows
                reattach with zero data movement; revoked ones are written
                back into fresh rows in place.
  drop and      when the victim's decoder is relay-compatible and the radix
  recompute     cache covers enough of its stream that re-prefilling the
                cold tail beats a host round trip (``SwapCostModel``,
                measured bandwidth), release everything and re-enter the
                scheduler as an internal prefill request keyed by the full
                token stream.

Victim selection (``PreemptionPolicy``): lowest priority first, then fewest
private pages resident (cheapest to move), then oldest admission.
Hysteresis makes a freshly resumed victim immune for a few steps, so tight
pools degrade to backpressure instead of thrashing. Swap resumes a victim
with its own KV, so its tokens are those of a run never preempted (greedy
and seeded: sampling keys fold from (seed, absolute position)). Recompute
replays the stream through the base prefill, which rounds decode-written
rows differently (S=1 against S>1 projections); it is held to TOKEN
identity with the un-preempted run, as relay is, never to page equality.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.kvcache.blocks import PoolExhausted
from repro_torch.kvcache.swap import HostSwapPool
from repro_torch.serving.costmodel import CostModel, SwapCostModel
from repro_torch.serving.scheduler import Request


@dataclass
class PreemptConfig:
    #: admission may draw the pool down to reserve / overcommit instead of
    #: the full worst-case decode reserve: preemption is the escape hatch
    overcommit: float = 1.0
    #: steps a freshly resumed victim is immune from re-preemption
    hysteresis_steps: int = 4
    #: auto (cost model decides) | swap | recompute (forced)
    mode: str = "auto"

    def __post_init__(self):
        if self.overcommit < 1.0:
            raise ValueError(f"overcommit factor must be >= 1, got "
                             f"{self.overcommit}")
        if self.hysteresis_steps < 0:
            raise ValueError("hysteresis_steps must be >= 0")
        if self.mode not in ("auto", "swap", "recompute"):
            raise ValueError(f"preemption mode {self.mode!r} not in "
                             f"('auto', 'swap', 'recompute')")


@dataclass
class SwapRecord:
    """One parked (swap-mode) victim: the sequence itself, where its
    private pages sat in the block table, and which of them still own
    their device rows (``resident`` shrinks when ``alloc`` revokes a row)."""
    seq: object                       # the parked DecodeSeq
    slots: list                       # [(block table index, page id), ...]
    resident: set = field(default_factory=set)


class PreemptionPolicy:
    """Victim ordering: priority asc -> fewest private pages -> oldest rid."""

    @staticmethod
    def order(seqs):
        return sorted(seqs, key=lambda s: (s.priority,
                                           len(s.private_blocks), s.rid))


class SwapManager:
    """The engine's preemption subsystem (``engine.swap``; None unless
    ``preempt=True``). The scheduler drives it at three points per step:
    ``resume_step`` (bring parked victims back when pages allow),
    ``preempt_step`` (evict when the highest-priority pending request is
    page-blocked) and ``grow_guard`` (emergency eviction when overcommit
    left the pool unable to grow active tails)."""

    def __init__(self, engine, cfg: PreemptConfig):
        self.engine = engine
        self.cfg = cfg
        self.pool = engine.block_pool
        self.costmodel = SwapCostModel(CostModel(engine.cfg))
        self.host = HostSwapPool(observe=self.costmodel.observe)
        self.records: dict[int, SwapRecord] = {}   # rid -> parked victim
        self._bid2rid: dict[int, int] = {}
        self.resume_counts: dict[int, int] = {}    # thrash gauge
        self.modes: list[str] = []                 # path taken per preemption
        self._last_resume_step: dict[int, int] = {}
        self.pool.add_swap_reclaim_callback(self._on_revoked)

    @property
    def parked(self) -> bool:
        return bool(self.records)

    def _on_revoked(self, bid: int) -> None:
        """Pool callback: ``alloc`` handed a SWAPPED page's device row to a
        new owner; the victim's copy survives only in the host tier now."""
        rid = self._bid2rid.pop(bid, None)
        if rid is not None:
            self.records[rid].resident.discard(bid)

    # ------------------------------------------------------------------
    # victim selection helpers
    # ------------------------------------------------------------------
    def _immune(self, seq) -> bool:
        last = self._last_resume_step.get(seq.rid)
        if last is None:
            return False
        steps = self.engine.scheduler.stats.steps
        return steps - last < self.cfg.hysteresis_steps

    def _stream(self, seq) -> list:
        """Token stream whose KV the victim's cache holds: the prompt, the
        handoff's first decode input, then the generated tokens bar the
        last (whose KV was never written). ``len == seq.pos``, the keying
        of ``_relay_publish``."""
        return list(seq.tokens) + [seq.first0] + [int(t) for t in seq.out[:-1]]

    def _mode_for(self, seq) -> str:
        """swap or drop-and-recompute for this victim. Recompute is legal
        ONLY for relay-compatible decoders (``engine._relay_compatible``):
        resuming replays the stream through the BASE prefill, so the
        victim's KV path must be the base's. The replayed rows are not
        bit-equal to the decode-written ones (S=1 and S>1 projections round
        differently); the contract is token identity, as for relay. Among
        legal options the measured-bandwidth cost model picks the cheaper
        restore."""
        eng = self.engine
        dw = eng.decoders.get(seq.model_id)
        recompute_ok = (eng.relay and dw is not None and dw.relay_compatible
                        and seq.tokens)
        if self.cfg.mode == "swap" or not recompute_ok:
            return "swap"
        if self.cfg.mode == "recompute":
            return "recompute"
        if not seq.private_blocks:
            return "recompute"       # nothing to swap; dropping frees refs
        stream = self._stream(seq)
        cold = len(stream) - eng.prefix_index.match_len(stream)
        return self.costmodel.choose(
            swap_bytes=len(seq.private_blocks) * eng.kvpool.page_bytes,
            cold_tokens=cold, kv_len=len(stream))

    # ------------------------------------------------------------------
    # preemption
    # ------------------------------------------------------------------
    def _shortfall(self, sched):
        """Pages missing for the highest-priority pending request's next
        move (chunk growth or decode admission). Returns (deficit_pages,
        priority) or None when no pending request is page-blocked."""
        if not sched.prefilling:
            return None
        page = self.engine.page_size
        r = max(sched.prefilling, key=lambda q: (q.priority, -q.seq))
        if r.done < r.n:
            take = min(sched.cfg.chunk_size, r.n - r.done)
            need = -(-(r.done + take) // page) - len(r.block_table)
        else:
            cow = 1 if r.n % page else 0
            need = cow + (-(-(r.n + r.gen_tokens) // page)
                          - (-(-r.n // page)))
        if need <= 0:
            return None
        deficit = need + sched._reserve_target() - self.pool.free_count
        if deficit <= 0:
            return None
        return deficit, r.priority

    def preempt_step(self, sched) -> int:
        """Evict low-priority decodes while the highest-priority pending
        request cannot obtain pages. Only strictly lower-priority sequences
        are victims (equal priority degrades to backpressure: no peer
        thrash)."""
        info = self._shortfall(sched)
        if info is None:
            return 0
        deficit, p_hi = info
        preempted = 0
        for victim in PreemptionPolicy.order(list(sched.active)):
            if victim.priority >= p_hi:
                break                       # sorted: no victims remain
            if victim.remaining <= 0 or self._immune(victim):
                continue
            freed = self._preempt_one(victim)
            if freed is None:
                continue
            preempted += 1
            deficit -= freed
            if deficit <= 0:
                break
        return preempted

    def grow_guard(self, sched) -> int:
        """Emergency phase right before decode: overcommit may have drawn
        the pool below the active tails' entitlement, and the tail-page
        ``alloc`` inside the decode step must never fail mid-flight.
        Preempt (lowest priority, preferring sequences that themselves need
        growth: each such eviction strictly improves the balance) until
        every tail page the coming step needs is coverable."""
        page = self.engine.page_size
        growing = [s for s in sched.active
                   if s.pos >= len(s.block_table) * page]
        need = len(growing)
        if need == 0 or self.pool.free_count >= need:
            return 0
        grows = {id(s) for s in growing}
        victims = sorted(sched.active,
                         key=lambda s: (s.priority, id(s) not in grows,
                                        len(s.private_blocks), s.rid))
        preempted = 0
        for s in victims:
            if self.pool.free_count >= need:
                break
            if s.remaining <= 0 or self._immune(s):
                continue
            was_growing = id(s) in grows
            if self._preempt_one(s, allow_empty=True) is None:
                continue
            preempted += 1
            if was_growing:
                need -= 1
        return preempted

    def _preempt_one(self, seq, allow_empty: bool = False):
        """Park one victim; returns the pages returned to the pool's free
        capacity, or None if preempting it would reclaim nothing."""
        mode = self._mode_for(seq)
        if mode == "swap" and not seq.private_blocks and not allow_empty:
            return None
        before = self.pool.free_count
        pages = len(seq.private_blocks)
        if mode == "swap":
            self._swap_out(seq)
        else:
            self._drop_recompute(seq)
        self.engine.stats.preemptions += 1
        self.modes.append(mode)
        self.engine.metrics_registry.trace(seq.rid).event(
            "preempted", mode=mode, pages=pages)
        return self.pool.free_count - before

    def _swap_out(self, seq) -> None:
        eng = self.engine
        pset = set(seq.private_blocks)
        slots = [(i, bid) for i, bid in enumerate(seq.block_table)
                 if bid in pset]
        bids = [bid for _, bid in slots]
        if bids:
            nbytes = self.host.put(eng.kvpool, seq.rid, bids)
            eng.stats.swap_out_pages += len(bids)
            eng.stats.swap_bytes += nbytes
        self.pool.swap_out(bids)
        for bid in bids:
            self._bid2rid[bid] = seq.rid
        self.records[seq.rid] = SwapRecord(seq=seq, slots=slots,
                                           resident=set(bids))
        eng.scheduler.active.remove(seq)

    def _drop_recompute(self, seq) -> None:
        """Release the victim entirely and re-enter it as an internal
        prefill request over its full token stream: the radix cache serves
        whatever prefix survives (shared pages go to CACHED right here),
        the cold tail re-prefills through the normal chunk machinery, and
        ``_promote`` routes the handoff back through
        ``finish_recompute_resume``."""
        eng = self.engine
        sched = eng.scheduler
        stream = self._stream(seq)
        self.pool.unref(seq.shared_blocks)
        self.pool.drop(seq.private_blocks)
        sched.active.remove(seq)
        params = dataclasses.replace(seq.params, max_tokens=seq.remaining)
        sched.waiting.append(Request(
            rid=seq.rid, sid=seq.sid, model_id=seq.model_id, tokens=stream,
            gen_tokens=seq.remaining, first_token=seq.next_token,
            priority=seq.priority, seq=eng._next_seq, params=params,
            resume_seq=seq))
        eng._next_seq += 1

    # ------------------------------------------------------------------
    # resume
    # ------------------------------------------------------------------
    def _pending_outranks(self, priority: int) -> bool:
        sched = self.engine.scheduler
        return (any(r.priority > priority for r in sched.waiting)
                or any(r.priority > priority for r in sched.prefilling))

    def resume_step(self, sched) -> int:
        """Un-park swap-mode victims, highest priority first, when (a) no
        strictly higher-priority request is still pending and (b) the pool
        can host the victim's pages PLUS its remaining tail growth above
        the admission reserve: resuming must never re-create the pressure
        that parked it."""
        if not self.records:
            return 0
        page = self.engine.page_size
        resumed = 0
        order = sorted(self.records,
                       key=lambda rid: (-self.records[rid].seq.priority, rid))
        for rid in order:
            rec = self.records[rid]
            seq = rec.seq
            if self._pending_outranks(seq.priority):
                continue
            missing = [(j, ti) for j, (ti, bid) in enumerate(rec.slots)
                       if bid not in rec.resident]
            growth = max(0, -(-(seq.pos + seq.remaining) // page)
                         - len(seq.block_table))
            if (self.pool.free_count - len(rec.resident) - len(missing)
                    - growth < sched._reserve_target()):
                continue
            if self._resume_one(rid, rec, missing):
                resumed += 1
        return resumed

    def _resume_one(self, rid: int, rec: SwapRecord, missing) -> bool:
        eng = self.engine
        seq = rec.seq
        # reclaim the still-resident rows FIRST (zero data movement, cannot
        # fail) so the allocation below can never revoke this record's own
        # pages out from under the resume
        still = [bid for _, bid in rec.slots if bid in rec.resident]
        self.pool.reclaim_swapped(still)
        fresh = []
        try:
            if missing:
                fresh = self.pool.alloc(len(missing))
        except PoolExhausted:
            # roll back to parked: the reclaimed rows return to the tier
            self.pool.swap_out(still)
            return False
        if missing:
            nbytes = self.host.restore(
                eng.kvpool, rid, [j for j, _ in missing], fresh)
            remap = {}
            for (j, ti), nb in zip(missing, fresh):
                seq.block_table[ti] = nb
                remap[rec.slots[j][1]] = nb
            seq.private_blocks = [remap.get(b, b)
                                  for b in seq.private_blocks]
            eng.stats.swap_in_pages += len(missing)
            eng.stats.swap_bytes += nbytes
        for _, bid in rec.slots:
            self._bid2rid.pop(bid, None)
        self.host.pop(rid)
        del self.records[rid]
        eng.scheduler.active.append(seq)
        self._mark_resumed(rid, "swap", len(missing))
        return True

    def finish_recompute_resume(self, req, seq) -> None:
        """``_promote`` hook for a drop-and-recompute victim's internal
        request: the handoff built a fresh DecodeSeq over the re-prefilled
        stream; graft the victim's identity back on so the continuation
        reads as never preempted (out, params, prompt restored; pos,
        next_token and remaining are already exact)."""
        victim = req.resume_seq
        seq.out = victim.out
        seq.tokens = victim.tokens
        seq.first0 = victim.first0
        seq.params = victim.params
        seq.priority = victim.priority
        self._mark_resumed(seq.rid, "recompute", 0)

    def _mark_resumed(self, rid: int, mode: str, pages: int) -> None:
        self.resume_counts[rid] = self.resume_counts.get(rid, 0) + 1
        self._last_resume_step[rid] = self.engine.scheduler.stats.steps
        self.engine.metrics_registry.trace(rid).event(
            "resumed", mode=mode, pages=pages)

    # ------------------------------------------------------------------
    # abort while swapped
    # ------------------------------------------------------------------
    def abort(self, rid: int) -> None:
        """Drop a parked victim: cached-prefix refs released, still-resident
        swapped rows freed (revoked rows already belong to new owners),
        host copy discarded; the pool returns exactly to baseline."""
        rec = self.records.pop(rid)
        self.pool.unref(rec.seq.shared_blocks)
        self.pool.discard_swapped(
            [bid for _, bid in rec.slots if bid in rec.resident])
        for _, bid in rec.slots:
            self._bid2rid.pop(bid, None)
        self.host.pop(rid)
