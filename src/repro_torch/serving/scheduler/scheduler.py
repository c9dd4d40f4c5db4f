"""Continuous token-budget step scheduler: the engine's run loop.

Port of ``repro.serving.scheduler.scheduler``. Every engine step packs,
under one per-step token budget:
  - one decode token for EVERY active sequence (decode is never starved:
    each active sequence reserves one budget token), and
  - as many prefill CHUNKS as fit the remaining budget, split off waiting
    prompts at ``chunk_size`` granularity in policy order (fcfs/priority).

Long prompts therefore stop head-of-line-blocking the decode plane: a long
prompt becomes many budget-sized slices interleaved with everyone else's
decode steps (the paper's prefill-decode interference).

Data plane per chunk: pages are allocated CHUNK-GRANULARLY
(``CacheManager.extend``: only the pages this chunk spills into), and the
chunk runs through ``base_prefill_chunk``: one forward in which each layer
scatters its fresh K/V into the pages and attends prefix plus chunk straight
from the pool with ``flash_prefill_paged``, with no dense gather. Equal-length
chunks from different requests batch into ONE base-model forward.

Backpressure: ``PoolExhausted`` on a chunk's page growth (or on the
handoff's copy-on-write clone) holds that request (pages it already
computed stay put) and retries after decode steps free pages; a step that
can make no progress at all raises ``PoolExhausted`` rather than spinning.

Oversubscription (``engine.swap``, ``serving/preempt.py``): with
preemption armed the admission reserve is scaled down by the overcommit
factor, parked victims resume and page-blocked high-priority work preempts
lower-priority decodes after admission (``_oversub_phase``), and an
emergency eviction right before decode keeps tail growth from failing
mid-step (``_tail_growth_guard``). A drop-and-recompute victim re-enters as
an internal request (``Request.resume_seq``). The autoscaler resizes the
prefill pool and the decode reserve at the step boundary
(``engine._autoscale_tick``), and the pool sanitizer censuses every page
after the step (``engine.sanitizer``).

The same object runs eager mode (chunking off): ``generate`` prefills whole
prompts synchronously, nothing waits in the queues, and a step is
decode-only.

Spans (``serving/metrics.py``, with the engine's metrics on): each step is
an ``engine.step`` span keyed by its number, with the children
``sched.reap``, ``sched.admit``, ``sched.plan``, ``model.chunk`` (one per
equal-length chunk forward; child ``model.chunk.sync``), ``sched.promote``
(child ``kv.handoff`` per handoff), ``model.decode`` (child
``model.decode.readback``) and ``engine.push``; its attributes count the
step's ``decode_rows``, ``grid_rows`` (the fused grid's rows, padding
included), ``chunk_tokens``, ``chunk_forwards``, ``held`` (admissions held
behind an in-flight identical context) and ``stalls``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from time import perf_counter_ns

from repro_torch.core.prefillshare import base_prefill_chunk
from repro_torch.device import synchronize
from repro_torch.kvcache.blocks import PoolExhausted
from repro_torch.serving.decode import next_pow2
from repro_torch.serving.metrics import (SPAN_ADMIT, SPAN_CHUNK,
                                         SPAN_CHUNK_FWD, SPAN_CHUNK_SYNC,
                                         SPAN_PLAN, SPAN_PROMOTE, SPAN_REAP,
                                         SPAN_ROUTED, SPAN_STEP)
from repro_torch.serving.scheduler.queue import POLICIES, order_requests


@dataclass
class SchedulerConfig:
    token_budget: int = 256      # per-step cap: decode tokens + chunk tokens
    chunk_size: int = 64         # max prefill tokens per request per step
    policy: str = "fcfs"         # fcfs | priority (queue.py)

    def __post_init__(self):
        if self.token_budget <= 0 or self.chunk_size <= 0:
            raise ValueError(f"token_budget {self.token_budget} and "
                             f"chunk_size {self.chunk_size} must be > 0")
        if self.policy not in POLICIES:
            raise ValueError(f"sched_policy {self.policy!r} not in {POLICIES}")


@dataclass
class SchedStats:
    steps: int = 0
    chunks: int = 0
    chunk_tokens: int = 0
    stalls: int = 0              # chunk/handoff attempts deferred on pool
                                 # pressure
    max_prefill_batch: int = 0   # widest batched chunk forward


@dataclass(eq=False)             # identity equality: list.remove stays O(1)
class Request:
    """One submitted generation request moving WAITING -> PREFILL -> DECODE."""
    rid: int
    sid: int
    model_id: str | None         # None: prefill-only (max_tokens == 0)
    tokens: list
    gen_tokens: int
    first_token: int
    priority: int
    seq: int                     # arrival order (fcfs tiebreak)
    params: object = None        # SamplingParams
    tok_hash: int = 0            # precomputed hash of tokens (sibling check)
    worker: object = None        # PrefillWorker, assigned at admission
    alloc: object = None         # CacheManager Allocation (chunk-granular)
    block_table: list = field(default_factory=list)
    done: int = 0                # tokens whose KV is in pages (incl. cached)
    committed: bool = False      # published to the radix index / session
    sibling_bt: list | None = None   # identical-context fast path table
    resume_seq: object = None    # preempted DecodeSeq this request restores
                                 # (drop-and-recompute, serving/preempt.py)

    def __post_init__(self):
        self.tok_hash = hash(tuple(self.tokens))

    @property
    def n(self) -> int:
        return len(self.tokens)

    @property
    def cached_tokens(self) -> int:
        """Prompt tokens served from the prefix cache at admission: the
        cached-history vs cold classification signal (queue.py)."""
        if self.sibling_bt is not None:
            return self.n
        return self.alloc.cached_tokens if self.alloc is not None else 0


class ChunkedScheduler:
    """Owns the engine step loop (chunked and eager modes)."""

    def __init__(self, engine, cfg: SchedulerConfig):
        self.engine = engine
        self.cfg = cfg
        self.waiting: list[Request] = []
        self.prefilling: list[Request] = []
        self.active: list = []           # DecodeSeqs (engine dataclass)
        self.stats = SchedStats()
        self.promoted: list[int] = []    # rids in prefill-completion order
        # this step's counts for its span: admissions held, chunk forwards,
        # decode rows and the decode grid's rows
        self._held = self._forwards = self._rows = self._grid = 0

    # ------------------------------------------------------------------
    def add(self, req: Request) -> None:
        self.waiting.append(req)

    def add_decode_seq(self, seq) -> None:
        """Register an already-prefilled sequence (eager mode)."""
        self.active.append(seq)

    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.active
                    or self._swap_parked())

    def _swap_parked(self) -> bool:
        """Swap-mode preemption victims parked off the step loop: still the
        engine's work (they resume and finish) though they sit in none of
        the three queues."""
        swap = self.engine.swap
        return swap is not None and swap.parked

    def run(self) -> None:
        while self.has_work():
            self.step()

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine step: reap finished sequences (their budget slots and
        pages free BEFORE this step's packing); apply deferred model churn;
        observe the step's metrics and let the autoscaler act on them;
        admit; resume or preempt (oversubscription); pack prefill chunks
        under the budget; promote finished prefills (zero-copy handoff);
        guard tail growth; advance every active sequence one decode token;
        census the pool (sanitizer)."""
        self.stats.steps += 1
        st, sp = self.stats, self.engine.spans
        step_span = sp.open(SPAN_STEP, st.steps)
        tokens0, stalls0 = st.chunk_tokens, st.stalls
        self._held = self._forwards = self._rows = self._grid = 0
        try:
            phase = sp.open(SPAN_REAP)
            progress = self._reap_finished()
            sp.close(phase)
            # step boundary: finalize drained unregisters (the reap may
            # have retired a draining model's last sequence) and relayout
            # the fused plane; lane indices are re-derived from the new
            # plane this step
            self.engine.models.sync()
            # same boundary: queue depth and pool occupancy into the
            # metrics, then the autoscaler resizes the prefill pool or the
            # decode reserve off those signals (worker-set changes are
            # legal only here)
            self.engine._observe_step()
            self.engine._autoscale_tick()
            phase = sp.open(SPAN_ADMIT)
            progress += self._admit()
            sp.close(phase)
            progress += self._oversub_phase()
            budget = self.cfg.token_budget - len(self.active)
            phase = sp.open(SPAN_PLAN)
            chunks = self._plan_chunks(budget)
            sp.close(phase)
            progress += self._run_chunks(chunks)
            phase = sp.open(SPAN_PROMOTE)
            progress += self._promote()
            sp.close(phase)
            progress += self._tail_growth_guard()
            progress += self._decode_phase()
            if self.engine.sanitizer is not None:
                # step boundary: every transient ref has settled, so the
                # pool / index / holder census must hold exactly here
                self.engine.sanitizer.check_step()
            if progress == 0 and (self.waiting or self.prefilling
                                  or self._swap_parked()):
                if self.engine.sched_reserve_extra > 0:
                    # the autoscaler's extra decode headroom is advisory: if
                    # it is all that blocks progress, give it back and retry
                    self.engine.sched_reserve_extra = 0
                    return
                swap = self.engine.swap
                raise PoolExhausted(
                    f"scheduler stalled: {len(self.waiting)} waiting / "
                    f"{len(self.prefilling)} prefilling / "
                    f"{len(swap.records) if swap is not None else 0} "
                    f"swapped-out requests cannot obtain pages and no "
                    f"decode is active to free any")
        finally:
            sp.close(step_span, {
                "decode_rows": self._rows, "grid_rows": self._grid,
                "chunk_tokens": st.chunk_tokens - tokens0,
                "chunk_forwards": self._forwards, "held": self._held,
                "stalls": st.stalls - stalls0}
                if self.engine._metrics_on else None)

    # ---- oversubscription (serving/preempt.py) -------------------------
    def _oversub_phase(self) -> int:
        """After admission, before chunk packing: resume parked victims when
        pages allow, then preempt low-priority decodes when the highest-
        priority pending request is page-blocked. Runs before the budget is
        computed so a resumed sequence claims its decode slot this step."""
        swap = self.engine.swap
        if swap is None:
            return 0
        return swap.resume_step(self) + swap.preempt_step(self)

    def _tail_growth_guard(self) -> int:
        """Right before decode: with overcommit the admission reserve is
        under-scaled on purpose, so the pool may lack the tail pages the
        coming decode step must allocate; evict victims until it cannot
        fail mid-flight."""
        swap = self.engine.swap
        if swap is None:
            return 0
        return swap.grow_guard(self)

    # ---- admission ----------------------------------------------------
    def _admit(self) -> int:
        admitted = 0
        for r in order_requests(list(self.waiting), self.cfg.policy):
            # hold a request whose identical context is already in flight:
            # once the leader promotes, the session fast path serves it
            # without recomputing. Hash-only compare: a collision just
            # delays admission one step; the fast path rechecks the tokens.
            if any(p.sid == r.sid and p.tok_hash == r.tok_hash
                   for p in self.prefilling):
                self._held += 1
                continue
            self.waiting.remove(r)
            w = self.engine._pick_worker(r.sid, r.tokens)
            r.worker = w
            self.engine.metrics_registry.trace(r.rid).event(
                SPAN_ROUTED, worker=w.wid)
            sc = w.sessions.get(r.sid)
            if sc is not None and sc.tokens == r.tokens:
                # identical-context sibling: the session's pages already
                # hold it (no allocation, no chunks, straight to promote).
                # Pin the pages NOW: promotion may be deferred under pool
                # pressure and the leader session could end meanwhile; the
                # pin is dropped after the handoff takes its own refs.
                self.engine.block_pool.ref(sc.block_table)
                w.mgr.record_hit(r.n)
                self.engine.stats.prefill_tokens_reused += r.n
                r.sibling_bt = list(sc.block_table)
                r.done = r.n
            else:
                r.alloc = w.mgr.begin(r.tokens)
                r.block_table = list(r.alloc.cached_blocks)
                r.done = r.alloc.cached_tokens
                self.engine.stats.prefill_tokens_reused += r.done
                w.pending_chunk_tokens += r.n - r.done
            if r.resume_seq is not None:
                # drop-and-recompute restore: the cache-cold tail of the
                # victim's stream is genuine recompute work
                self.engine.stats.recompute_tokens += r.n - r.done
            else:
                ph = self.engine._phases.get(r.rid)
                if ph is not None:
                    ph.cached = r.done
            self.prefilling.append(r)
            admitted += 1
        return admitted

    # ---- prefill chunk packing ----------------------------------------
    def _plan_chunks(self, budget: int):
        """Split pending prompts into (request, start, take) chunks, policy
        order, chunk-granular page growth; pool pressure defers a request."""
        page = self.engine.page_size
        chunks = []
        # prefill never takes the pool below the pages active decodes are
        # still entitled to (worst-case tail growth, overcommit-scaled) plus
        # the autoscaler's extra decode headroom, so chunking cannot starve
        # the decode plane mid-flight
        reserve = self._reserve_target()
        pool = self.engine.block_pool
        pending = [r for r in self.prefilling
                   if r.done < r.n and r.sibling_bt is None]
        # cached-history prefills pack ahead of cold prompts (within a
        # priority class): their remaining work is a chunk or two. The
        # reference makes this a config field that no caller turns off;
        # here it is always on (schedule only: tokens stay identical)
        for r in order_requests(pending, self.cfg.policy, cached_first=True):
            if budget <= 0:
                break
            take = min(self.cfg.chunk_size, r.n - r.done, budget)
            need = -(-(r.done + take) // page) - len(r.block_table)
            if need > 0:
                if pool.free_count - need < reserve:
                    self.stats.stalls += 1
                    continue          # hold; decode may free pages
                try:
                    fresh = r.worker.mgr.extend(r.alloc, need)
                except PoolExhausted:
                    self.stats.stalls += 1
                    continue
                r.block_table.extend(fresh)
            chunks.append((r, r.done, take))
            budget -= take
        return chunks

    def _run_chunks(self, chunks) -> int:
        """Execute planned chunks; equal-length chunks from different
        requests run as ONE batched base-model forward over the pool."""
        if not chunks:
            return 0
        eng = self.engine
        sp, phases = eng.spans, eng._phases
        groups: dict[int, list] = {}
        for r, start, take in chunks:
            groups.setdefault(take, []).append((r, start))
        for S, items in groups.items():
            B = len(items)
            # bucket the chunk block-table width to the next power of two,
            # as the fused decode step buckets decode tables: the shapes a
            # chunk forward sees grow O(log) with the prefix (padding =
            # sentinel page 0, never visible)
            npages = next_pow2(max(len(r.block_table) for r, _ in items))
            toks = [[0] * S for _ in range(B)]
            bt = [[0] * npages for _ in range(B)]
            pos = [0] * B
            for i, (r, start) in enumerate(items):
                toks[i] = r.tokens[start:start + S]
                bt[i][:len(r.block_table)] = r.block_table
                pos[i] = start
            c0 = perf_counter_ns() if phases else 0
            span = sp.open(SPAN_CHUNK_FWD)
            t0 = time.perf_counter()
            base_prefill_chunk(eng.cfg, eng.base_params, toks,
                               pool=eng.kvpool, block_tables=bt, pos=pos)
            sync = sp.open(SPAN_CHUNK_SYNC)
            synchronize(eng.device)        # the router's EWMA needs real time
            sp.close(sync)
            dt = time.perf_counter() - t0
            sp.close(span, {"B": B, "S": S, "npages": npages,
                            "rids": [r.rid for r, _ in items]}
                     if eng._metrics_on else None)
            c1 = perf_counter_ns() if phases else 0
            self._forwards += 1
            for r, _ in items:
                r.done += S
                r.worker.pending_chunk_tokens -= S
                r.worker.ewma.observe(S, dt / B)
                eng.metrics_registry.trace(r.rid).event(
                    SPAN_CHUNK, tokens=S, done=r.done)
                ph = phases.get(r.rid) if r.resume_seq is None else None
                if ph is not None:
                    ph.chunk0 = ph.chunk0 or c0
                    ph.chunk1 = c1
            eng.stats.prefill_tokens_computed += B * S
            self.stats.chunks += B
            self.stats.chunk_tokens += B * S
            self.stats.max_prefill_batch = max(self.stats.max_prefill_batch, B)
        return len(chunks)

    def _decode_reserve(self) -> int:
        """Pages the active decode sequences are still entitled to: the
        worst-case tail growth each committed-to generation may yet need.
        Prefill chunking and decode admission both stay above this line, so
        a running generation never hits PoolExhausted mid-flight."""
        page = self.engine.page_size
        return sum(
            max(0, -(-(s.pos + s.remaining) // page) - len(s.block_table))
            for s in self.active)

    def _reserve_target(self) -> int:
        """Admission floor: the decode reserve, scaled down by the
        overcommit factor when preemption is armed (victims are the escape
        hatch, so the pool may admit beyond the strict worst case), plus
        the autoscaler's extra decode headroom."""
        reserve = self._decode_reserve()
        swap = self.engine.swap
        if swap is not None and swap.cfg.overcommit > 1.0:
            reserve = -(-reserve // swap.cfg.overcommit)
        return int(reserve) + self.engine.sched_reserve_extra

    # ---- prefill -> decode handoff -------------------------------------
    def _commit_request(self, r: Request) -> None:
        """Publish a fully prefilled (non-sibling) request for prefix reuse
        and session bookkeeping, exactly once (promotion may retry under
        pool pressure)."""
        if r.committed:
            return
        from repro_torch.serving.engine import PagedSession
        w = r.worker
        w.mgr.commit(r.tokens, r.alloc)
        old = w.sessions.get(r.sid)
        w.sessions[r.sid] = PagedSession(
            r.alloc, list(r.block_table), r.n, list(r.tokens))
        if old is not None:
            w.mgr.release(old.alloc)
        r.committed = True

    def _promote(self) -> int:
        promoted = 0
        page = self.engine.page_size
        pool = self.engine.block_pool
        for r in list(self.prefilling):
            if r.done < r.n:
                continue
            if r.gen_tokens == 0:
                # prefill-only request (SharedContext warm-up): commit the
                # session and finish; no decode model, no handoff, no CoW
                if r.sibling_bt is not None:
                    pool.unref(r.sibling_bt)
                else:
                    self._commit_request(r)
                self.prefilling.remove(r)
                self.promoted.append(r.rid)
                self._mark_promoted(r.rid)
                self.engine._finish_prefill_only(r.rid)
                promoted += 1
                continue
            # decode admission control: the handoff's CoW clone plus THIS
            # sequence's worst-case tail growth must fit above the pages
            # running decodes are entitled to, or admitting it could
            # deadlock every generation mid-flight
            cow = 1 if r.n % page else 0
            growth = -(-(r.n + r.gen_tokens) // page) - (-(-r.n // page))
            if pool.free_count - cow - growth < self._reserve_target():
                self.stats.stalls += 1
                continue
            bt = r.sibling_bt
            if bt is None:
                self._commit_request(r)
                bt = r.block_table
            try:
                seq = self.engine._handoff_seq(
                    bt, r.n, r.sid, r.model_id, r.params, r.first_token,
                    r.rid, tokens=r.tokens, priority=r.priority)
            except PoolExhausted:
                self.stats.stalls += 1   # CoW clone page unavailable: retry
                continue
            if r.sibling_bt is not None:
                pool.unref(r.sibling_bt)   # the handoff holds its own refs
            self.prefilling.remove(r)
            self.active.append(seq)
            if r.resume_seq is not None:
                # drop-and-recompute restore: graft the victim's identity
                # onto the re-prefilled sequence; its rid already completed
                # its public prefill, so it is not promoted again
                self.engine.swap.finish_recompute_resume(r, seq)
            else:
                self.promoted.append(r.rid)
                self._mark_promoted(r.rid)
            promoted += 1
        return promoted

    def _mark_promoted(self, rid: int) -> None:
        ph = self.engine._phases.get(rid)
        if ph is not None:
            ph.promote = perf_counter_ns()

    # ---- decode --------------------------------------------------------
    def _reap_finished(self) -> int:
        """Retire sequences whose generation is over: length exhausted OR
        ended early by an eos/stop token (``decode_step`` zeroes
        ``remaining``). Runs at the top of every step, so an early finish
        frees its budget slot, its decode-reserve pages and its pool pages
        before this step's packing."""
        still = []
        finished = 0
        for s in self.active:
            if s.remaining > 0:
                still.append(s)
            else:
                self.engine._finish(s)
                finished += 1
        self.active = still
        return finished

    def _decode_phase(self) -> int:
        """Advance every active sequence one token. The engine steps a COPY
        of the active list: stream callbacks fire inside decode_step and may
        re-enter the engine (abort() removes from ``self.active``, an eager
        generate() appends to it)."""
        if not self.active:
            return 0
        stepped = list(self.active)
        self._grid = self.engine.decode_step(stepped)
        self._rows = len(stepped)
        return len(stepped)
