"""Event-driven simulator for multi-model disaggregated serving.

Port of ``repro.serving.simulator``: the same event order and logic, line
for line. It reproduces the paper's serving experiments (Figs. 3-4) on one
H100's cost terms: every step is priced by ``serving/costmodel.py``'s
roofline at the H100's data-sheet peaks, a worker's device memory is its
cards times 80 GB, the dense handoff crosses NVLink 4 links
(``kvcache/handoff.py``), and the swap tier drains at the host link
``chip_smoke.py`` measured on the card.

  BASELINE      — N independent (prefill, decode) worker pairs, one per
                  specialized model. Every pair owns a private paged KV pool:
                  the same session prefix is prefilled and stored N times
                  (Eq. 8), so per-pool memory pressure is N× higher and LRU
                  eviction sets in early -> prefix-cache misses -> full
                  recompute -> tail-latency collapse under load.
  PREFILLSHARE  — one shared frozen base model across the prefill pool;
                  sessions are pinned to a prefill worker (prefix-locality
                  routing), the cache is computed once and incrementally
                  extended across agent switches, and pages are handed off to
                  ANY decode model (cache-conditioned decoders accept them) —
                  Eq. 9.

Decode workers run continuous batching with a fluid approximation (batch-
dependent inter-token latency re-evaluated on membership change) and model
Appendix-B.2 staging: when resident KV exceeds the decode worker's HBM
budget, handoff/reload cost inflates. Nothing here touches a device: the
simulator is numpy and pure Python over configs and seeded sessions.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.kvcache.blocks import PoolExhausted
from repro_torch.kvcache.handoff import NVLINK_LINKS, HandoffChannel
from repro_torch.kvcache.manager import (CacheManager, CacheStats,
                                         kv_bytes_per_token)
from repro_torch.serving.autoscale import (AutoscaleConfig, AutoscaleSignals,
                                           Autoscaler)
from repro_torch.serving.backpressure import B2Policy
from repro_torch.serving.costmodel import HBM_BYTES, CostModel
from repro_torch.serving.router import PrefillRouter
from repro_torch.serving.workload import Session

#: the host link of the swap tier (GB/s): the low end of the 1.13e10-1.47e10
#: B/s each way that ``chip_smoke.py`` phase 11 measured through pinned
#: memory on one NVIDIA H100 80GB HBM3 (700.00 W power limit)
SWAP_GBPS = 11.3
#: one decode-plane relayout (s): a fifth LoRA adapter registered on (or
#: unregistered from) a fused plane of four at Llama-3.1-8B width, and the
#: plane rebuilt at the next step boundary; the median of the six that
#: ``chip_smoke.py`` phase 18 timed on one NVIDIA H100 80GB HBM3 (700.00 W
#: power limit), which ranged 1.92e-4 to 5.83e-4 s. The port compiles
#: nothing at a relayout: it restacks the adapters' factors.
CHURN_REBUILD_S = 3.18e-4


@dataclass
class ServingConfig:
    mode: str = "prefillshare"          # or "baseline"
    n_models: int = 4
    n_prefill_workers: int = 4
    n_decode_workers: int = 4
    chips_per_worker: int = 4
    hbm_per_worker: float = 4 * HBM_BYTES   # cards * 80 GB (H100)
    block_size: int = 16
    max_concurrent: int = 64
    max_decode_batch: int = 64
    staging_penalty: float = 4.0
    handoff_links: int = NVLINK_LINKS   # an H100's NVLink 4 links
    b2_policy: str = "staging"   # staging | admission | backpressure | reservation
                                 # (Appendix B.2 alternatives; see backpressure.py)
    router_policy: str = "pinned"  # pinned | least_loaded | spillover (router.py)
    prefill_chunk_tokens: int = 0  # 0 = whole-prompt service; >0 = chunked
                                   # prefill (round-robin between queued
                                   # requests at chunk granularity — the
                                   # same token-budget slicing the real
                                   # engine's scheduler performs)
    eos_prob: float = 0.0          # per-token chance a generation stops
                                   # early (the engine's stop/eos finishes):
                                   # an invocation's realized length is
                                   # min(gen_tokens, 1 + Geometric(p)), so
                                   # early finishes free decode batch slots
                                   # and HBM mid-flight. 0 = exact lengths
                                   # (the historical behaviour).
    churn_interval_s: float = 0.0  # model-lifecycle churn (the engine's
                                   # ModelRegistry): every interval a decode
                                   # model hot-(un)registers mid-workload.
                                   # 0 = static model set (historical).
    churn_rebuild_s: float = CHURN_REBUILD_S
                                   # registry-rebuild cost per churn event:
                                   # the fused decode plane relayouts at a
                                   # step boundary, freezing every decode
                                   # worker's progress for this long —
                                   # fig3-style runs price churn with
                                   # exactly this stall.
    autoscale: object = None       # None = static split; True or an
                                   # AutoscaleConfig (serving/autoscale.py)
                                   # = metrics-driven elastic prefill:decode
                                   # scaling: worker pools are built at the
                                   # autoscale max sizes, n_prefill_workers/
                                   # n_decode_workers become the STARTING
                                   # active counts, and a recurring tick
                                   # shifts workers between the pools off
                                   # backlog/occupancy/TTFT signals.
    overcommit: float = 1.0        # admission oversubscription (the engine's
                                   # LocalDisaggEngine(overcommit=)): the
                                   # session cap is multiplied by this, and
                                   # decode HBM overflow is absorbed by the
                                   # host-memory swap tier instead of the
                                   # B.2 staging inflation. 1.0 = historical
                                   # behaviour (no swap tier).
    swap_gbps: float = SWAP_GBPS   # host<->device swap bandwidth (GB/s) the
                                   # swap tier drains overflow at; each
                                   # preemption stalls the worker for
                                   # excess_bytes / bandwidth (the engine's
                                   # measured-bandwidth SwapCostModel).


@dataclass
class InvocationRecord:
    sid: int
    inv_idx: int
    model_id: int
    issued: float
    ttft: float = 0.0
    done: float = 0.0
    gen_tokens: int = 0          # realized generation length (<= requested)
    finish_reason: str = "length"  # "eos" when eos_prob cut it short
    prefill_cached: int = 0
    prefill_new: int = 0
    staged: bool = False


@dataclass
class _SessionState:
    session: Session
    inv_idx: int = -1
    context: list = field(default_factory=list)
    allocs: dict = field(default_factory=dict)    # worker id -> Allocation
    started: float = 0.0
    records: list = field(default_factory=list)


class _PrefillWorker:
    """Single-server FIFO prefill worker with a paged prefix cache.

    ``chunk_tokens > 0`` models the real engine's chunked scheduler: a
    request is serviced in chunk-sized time slices and re-queued at the TAIL
    between slices, so a long prompt no longer head-of-line-blocks every
    request behind it for its whole service time."""

    def __init__(self, wid, cfg, cost, pool_bytes, block_size,
                 chunk_tokens: int = 0):
        self.wid = wid
        self.cost = cost
        self.chunk_tokens = chunk_tokens
        bpt = kv_bytes_per_token(cfg)
        n_blocks = max(64, int(pool_bytes / (bpt * block_size)))
        self.mgr = CacheManager(cfg, n_blocks, block_size)
        self.busy_until = 0.0
        self.queue = []
        self.busy_time = 0.0
        self.inflight_pages = 0   # worst-case pages of in-service requests

    def service_time(self, n_new, kv_len):
        return self.cost.prefill(max(n_new, 1), kv_len).seconds


class _DecodeWorker:
    """Continuous-batching decode worker (fluid approximation)."""

    def __init__(self, wid, cfg, cost, hbm_bytes, max_batch):
        self.wid = wid
        self.cfg = cfg
        self.cost = cost
        self.hbm = hbm_bytes
        self.max_batch = max_batch
        self.kv_per_tok = kv_bytes_per_token(cfg)
        self.weight_bytes = cfg.param_count() * 2
        self.active = {}        # rid -> dict(remaining, kv_len, meta)
        self.wait = []
        self.last_t = 0.0
        self.gen_tokens = 0
        self.swapped_bytes = 0.0   # overflow parked in the host swap tier

    # -- fluid batching ------------------------------------------------
    def resident_bytes(self):
        return sum(r["kv_len"] * self.kv_per_tok for r in self.active.values())

    def itl(self):
        if not self.active:
            return 0.0
        b = len(self.active)
        avg_kv = np.mean([r["kv_len"] for r in self.active.values()])
        t = self.cost.decode_step(b, avg_kv).seconds
        free = self.hbm - self.weight_bytes
        # swapped-out KV lives in host memory, not HBM: it neither inflates
        # the staging term nor counts against the budget (the swap stall is
        # priced separately, at preemption time)
        over = (max(0.0, self.resident_bytes() - self.swapped_bytes - free)
                / max(free, 1.0))
        return t * (1.0 + 3.0 * over)   # staging/reload inflation (B.2)

    def advance(self, now):
        """Progress all active requests from last_t to now; return finished.
        ``last_t`` never moves backwards: a churn stall parks it in the
        future, and advances inside the frozen window must not rewind it."""
        dt = now - self.last_t
        self.last_t = max(self.last_t, now)
        finished = []
        if not self.active or dt <= 0:
            return finished
        step = self.itl()
        steps = dt / step if step > 0 else 0.0
        for rid, r in list(self.active.items()):
            n = min(r["remaining"], steps)
            r["remaining"] -= n
            r["kv_len"] += n
            self.gen_tokens += n
            if r["remaining"] <= 1e-9:
                finished.append((rid, r))
                del self.active[rid]
        return finished

    def next_completion(self, now):
        if not self.active:
            return None
        step = self.itl()
        rem = min(r["remaining"] for r in self.active.values())
        return now + max(rem, 1e-6) * step


class Simulator:
    def __init__(self, model_cfg: ModelConfig, scfg: ServingConfig,
                 sessions: list[Session], seed: int = 0):
        self.cfg = model_cfg
        self.scfg = scfg
        self.sessions = sessions
        cost = CostModel(model_cfg, chips=scfg.chips_per_worker)
        kv_budget = scfg.hbm_per_worker - model_cfg.param_count() * 2
        assert kv_budget > 0, "worker HBM cannot even hold the weights"
        # elastic scaling (serving/autoscale.py): worker lists are built at
        # the autoscale MAX sizes; only the first n_*_on of each are routable
        # ("active"). A deactivated worker finishes what it holds (queued
        # prefills drain, decoding sequences run out) — it just receives no
        # new work, the same step-boundary semantics as the real engine.
        self.autoscaler = None
        n_pre, n_dec = scfg.n_prefill_workers, scfg.n_decode_workers
        max_pre, max_dec = n_pre, n_dec
        if scfg.autoscale is not None and scfg.mode == "prefillshare":
            acfg = scfg.autoscale
            if acfg is True:
                acfg = AutoscaleConfig(decode_slots=scfg.max_decode_batch)
            self.autoscaler = Autoscaler(acfg)
            acfg = self.autoscaler.cfg
            max_pre = max(n_pre, acfg.max_prefill)
            max_dec = max(n_dec, acfg.max_decode)
        self.prefill = [
            _PrefillWorker(i, model_cfg, cost, kv_budget, scfg.block_size,
                           chunk_tokens=scfg.prefill_chunk_tokens)
            for i in range(max_pre)]
        self.decode = [
            _DecodeWorker(i, model_cfg, cost, scfg.hbm_per_worker,
                          scfg.max_decode_batch)
            for i in range(max_dec)]
        self.n_prefill_on = n_pre
        self.n_decode_on = n_dec
        #: analytic per-token prefill seconds, for pricing queued backlog
        self._prefill_spt = cost.prefill(256, 0).seconds / 256
        self._ttft_window: list[float] = []    # recent TTFTs (p95 signal)
        self.handoff = HandoffChannel(model_cfg, n_links=scfg.handoff_links,
                                      staging_penalty=scfg.staging_penalty)
        max_ctx = max(
            s.system_tokens + sum(i.delta_tokens + i.gen_tokens
                                  for i in s.invocations)
            for s in sessions)
        self.b2 = B2Policy(scfg.b2_policy, model_cfg,
                           hbm_bytes=scfg.hbm_per_worker,
                           weight_bytes=model_cfg.param_count() * 2,
                           max_context_tokens=max_ctx)
        # oversubscription: the swap tier backs more admitted sessions than
        # decode HBM can hold at once (the engine's overcommit= knob)
        self.effective_cap = int(self.b2.session_cap(scfg.max_concurrent)
                                 * max(1.0, scfg.overcommit))
        self.router = PrefillRouter(scfg.n_prefill_workers,
                                    policy=scfg.router_policy)
        self.rng = np.random.default_rng(seed)     # eos_prob length draws
        self.events = []
        self._seq = itertools.count()
        self.admitted = 0
        self.admission_queue = []
        self.states: dict[int, _SessionState] = {}
        self.records: list[InvocationRecord] = []
        self.completed_sessions = []
        self.t_end = 0.0
        self.churn_events = 0
        self.churn_stall_s = 0.0
        self.resize_events = 0
        self.preemptions = 0
        self.swap_stall_s = 0.0
        if scfg.churn_interval_s > 0:
            self._push(scfg.churn_interval_s, "model_churn", None)
        if self.autoscaler is not None:
            self._push(self.autoscaler.cfg.interval_s, "autoscale_tick", None)

    # -- routing (paper §3.3 prefix-aware routing) ----------------------
    def route_prefill(self, st: _SessionState, model_id: int,
                      now: float = 0.0) -> _PrefillWorker:
        if self.scfg.mode != "prefillshare":
            return self.prefill[model_id % len(self.prefill)]
        active = self.prefill[:self.n_prefill_on]
        backlogs = [max(0.0, w.busy_until - now)
                    + 0.05 * len(w.queue) for w in active]
        return active[self.router.pick(st.session.sid, now, backlogs)]

    def route_decode(self, model_id: int) -> _DecodeWorker:
        return self.decode[model_id % self.n_decode_on]

    # -- event plumbing --------------------------------------------------
    def _push(self, t, kind, payload):
        heapq.heappush(self.events, (t, next(self._seq), kind, payload))

    def run(self):
        for s in self.sessions:
            self._push(s.arrival, "arrive", s)
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            getattr(self, f"_on_{kind}")(t, payload)
        return self.summary()

    # -- session lifecycle -------------------------------------------------
    def _on_arrive(self, t, session: Session):
        if (self.admitted >= self.effective_cap
                or not self.b2.try_reserve(session.sid)):
            self.admission_queue.append(session)
            return
        self._admit(t, session)

    def _admit(self, t, session: Session):
        self.admitted += 1
        st = _SessionState(session=session, started=t)
        st.context = session.fresh_tokens(session.system_tokens, salt=0)
        self.states[session.sid] = st
        self._next_invocation(t, st)

    def _next_invocation(self, t, st: _SessionState):
        st.inv_idx += 1
        if st.inv_idx >= len(st.session.invocations):
            self._finish_session(t, st)
            return
        inv = st.session.invocations[st.inv_idx]
        st.context += st.session.fresh_tokens(inv.delta_tokens,
                                              salt=1 + st.inv_idx * 2)
        rec = InvocationRecord(sid=st.session.sid, inv_idx=st.inv_idx,
                               model_id=inv.model_id, issued=t,
                               gen_tokens=inv.gen_tokens)
        st.records.append(rec)
        self.records.append(rec)
        w = self.route_prefill(st, inv.model_id, now=t)
        w.queue.append((st, inv, rec))
        self._kick_prefill(t, w)

    def _kick_prefill(self, t, w: _PrefillWorker):
        if w.busy_until > t or not w.queue:
            return
        # one pass over the queue: a request whose slice cannot obtain pages
        # is HELD at the tail (its computed pages stay pinned) and retried
        # when a later completion releases an allocation — the engine
        # scheduler's backpressure, in event form
        for _ in range(len(w.queue)):
            item = w.queue.pop(0)
            st, inv, rec = item[:3]
            prog = item[3] if len(item) > 3 else None
            if prog is None:             # first slice of this request
                tokens = list(st.context)
                if w.chunk_tokens:
                    # worst-case admission control (the engine's promote
                    # gate, prefill-side): start slicing a new prompt only
                    # if its full page footprint fits alongside the prompts
                    # already in service — round-robin then cannot pin the
                    # pool dry mid-prefill, and tight pools degrade to the
                    # serial service the unchunked mode models
                    bs = w.mgr.pool.block_size
                    need = -(-len(tokens) // bs)
                    if (w.inflight_pages
                            and w.inflight_pages + need > w.mgr.pool.num_blocks):
                        w.queue.append((st, inv, rec))   # unstarted: unpinned
                        continue
                    # chunk-granular growth, mirroring the engine's
                    # scheduler: only the prefix is claimed now; tail pages
                    # arrive with each slice (extend below), so interleaved
                    # long prompts hold computed pages, not whole-prompt
                    # allocations
                    alloc = w.mgr.begin(tokens)
                    w.inflight_pages += need
                else:
                    need = 0
                    alloc = w.mgr.acquire(tokens)  # pool >= one max-ctx req
                    w.mgr.commit(tokens, alloc)
                n_new = alloc.total_tokens - alloc.cached_tokens
                rec.prefill_cached = alloc.cached_tokens
                rec.prefill_new = n_new
                prog = {"alloc": alloc, "tokens": tokens, "n_new": n_new,
                        "done": 0, "pages": need}
            alloc = prog["alloc"]
            remaining = prog["n_new"] - prog["done"]
            chunk = remaining if not w.chunk_tokens else min(w.chunk_tokens,
                                                            remaining)
            if w.chunk_tokens:
                bs = w.mgr.pool.block_size
                covered = alloc.cached_tokens + prog["done"] + chunk
                try:
                    w.mgr.extend(alloc,
                                 -(-covered // bs) - len(alloc.blocks))
                except PoolExhausted:
                    w.queue.append((st, inv, rec, prog))
                    continue
            # chunk service cost accounts for the prefix ALREADY in the
            # cache (cached hit + previously-computed chunks), mirroring the
            # engine's chunk forward attending to the growing paged prefix.
            dur = w.service_time(chunk, alloc.cached_tokens + prog["done"])
            w.busy_until = t + dur
            w.busy_time += dur
            prog["done"] += chunk
            self._push(t + dur, "prefill_chunk_done",
                       (w.wid, st, inv, rec, prog))
            return
        # every queued request is stalled on pool pressure with the worker
        # idle: no in-flight slice will ever release pages -> fail loudly
        # (the engine scheduler raises in the same no-progress situation).
        # The run ends here, so the stalled requests' partial allocations
        # go back to the pool on the way out: no page stays active without
        # an owner (the reference leaves them active).
        try:
            raise PoolExhausted(
                f"sim prefill worker {w.wid}: {len(w.queue)} chunked requests "
                f"hold partial allocations and none can grow")
        finally:
            for item in w.queue:
                if len(item) > 3:
                    w.mgr.abandon(item[3]["alloc"])

    def _on_prefill_chunk_done(self, t, payload):
        wid, st, inv, rec, prog = payload
        w = self.prefill[wid]
        if prog["done"] < prog["n_new"]:
            # requeue at the TAIL: other waiting requests get their slice
            # before this prompt's next chunk (no head-of-line blocking)
            w.queue.append((st, inv, rec, prog))
            self._kick_prefill(t, w)
            return
        if w.chunk_tokens:
            # publish for prefix reuse only once fully computed (the
            # engine's scheduler commits at promote time)
            w.mgr.commit(prog["tokens"], prog["alloc"])
            w.inflight_pages -= prog["pages"]
        # pages stay CACHED (LRU-evictable) for future prefix extension; the
        # decode side consumes its own handed-off copy, so no pin is needed.
        w.mgr.release(prog["alloc"])
        self._kick_prefill(t, w)
        self._try_handoff(t, st, inv, rec)

    def _try_handoff(self, t, st, inv, rec):
        # Hand the shared cache to the decode worker, subject to the B.2
        # policy (backpressure may defer until decode HBM can host the KV).
        dw = self.route_decode(inv.model_id)
        dw.advance(t)
        decision = self.b2.admit_decode(dw.resident_bytes(), len(st.context))
        if not decision.admit:
            self._push(t + decision.delay_hint_s, "handoff_retry",
                       (st, inv, rec))
            return
        free = dw.hbm - dw.weight_bytes - dw.resident_bytes()
        plan = self.handoff.plan(len(st.context), decode_hbm_free_bytes=int(free))
        rec.staged = plan.staged
        self._push(t + plan.seconds, "decode_start", (dw.wid, st, inv, rec))

    def _on_handoff_retry(self, t, payload):
        st, inv, rec = payload
        self._try_handoff(t, st, inv, rec)

    # -- model-lifecycle churn -------------------------------------------
    def _on_model_churn(self, t, _payload):
        """One hot (un)register event: the decode plane's stacked layout is
        rebuilt at a step boundary — modeled as every decode worker's
        fluid progress freezing for ``churn_rebuild_s`` (surviving
        sequences then resume bit-identically, so ONLY the stall is
        priced, never lost tokens)."""
        stall = self.scfg.churn_rebuild_s
        self.churn_events += 1
        for dw in self.decode:
            finished = dw.advance(t)
            for _rid, r in finished:
                self._decode_finished(t, r)
            if dw.active:
                # progress is frozen during [t, t + stall): advance() clamps
                # on dt <= 0, so the next decode_check simply sees no tokens
                # generated across the rebuild window
                dw.last_t = max(dw.last_t, t + stall)
                self.churn_stall_s += stall
                self._reschedule(t + stall, dw)
        # keep churning only while the workload is live (sessions in flight,
        # queued, or yet to arrive) — a recurring event on a drained
        # simulator would spin the loop forever
        if (self.states or self.admission_queue
                or any(kind == "arrive" for _, _, kind, _ in self.events)):
            self._push(t + self.scfg.churn_interval_s, "model_churn", None)

    # -- metrics-driven elastic scaling ----------------------------------
    def _autoscale_signals(self, t):
        """Control-loop inputs from the live fleet — the same signal set the
        real engine assembles from its metrics registry."""
        act_p = self.prefill[:self.n_prefill_on]
        backlog_tokens = 0
        busy_s = 0.0
        for w in act_p:
            busy_s += max(0.0, w.busy_until - t)
            for item in w.queue:
                if len(item) > 3 and item[3] is not None:      # mid-chunks
                    backlog_tokens += item[3]["n_new"] - item[3]["done"]
                else:
                    backlog_tokens += len(item[0].context)
        act_d = self.decode[:self.n_decode_on]
        inflight = sum(len(dw.active) for dw in act_d)
        # occupancy counts DEMAND, not just admitted work: sessions parked in
        # the admission queue (B.2 backpressure) are imminent decode load the
        # slots must absorb — without them the signal stays calm exactly when
        # decode is the bottleneck deferring admissions. inflight_decode stays
        # the admitted truth (the shrink-safety guard needs real residency).
        demand = inflight + len(self.admission_queue)
        slots = self.n_decode_on * self.scfg.max_decode_batch
        # decode KV headroom, the analog of the engine's shared-pool free
        # fraction: under B.2 backpressure a full decode HBM DEFERS handoffs
        # at the prefill side, so neither inflight nor the admission queue
        # ever shows the pressure — the resident-bytes headroom does.
        free_frac = min((max(0.0, 1.0 - dw.resident_bytes()
                             / max(dw.hbm - dw.weight_bytes, 1.0))
                         for dw in act_d), default=1.0)
        recent = self._ttft_window[-64:]
        ttft_p95 = (float(np.percentile(recent, 95)) if recent
                    else float("nan"))
        itls = [dw.itl() for dw in act_d if dw.active]
        return AutoscaleSignals(
            prefill_backlog_tokens=backlog_tokens,
            prefill_backlog_s=(backlog_tokens * self._prefill_spt + busy_s),
            decode_occupancy=demand / max(slots, 1),
            free_page_frac=free_frac,
            ttft_p95_s=ttft_p95,
            itl_p95_s=max(itls) if itls else float("nan"),
            n_prefill=self.n_prefill_on,
            n_decode=self.n_decode_on,
            inflight_decode=inflight)

    def _on_autoscale_tick(self, t, _payload):
        d = self.autoscaler.tick(self._autoscale_signals(t), t)
        if d:
            if d.prefill_delta > 0 and self.n_prefill_on < len(self.prefill):
                self.n_prefill_on += 1
            elif d.prefill_delta < 0 and self.n_prefill_on > 1:
                self.n_prefill_on -= 1
            if d.decode_delta > 0 and self.n_decode_on < len(self.decode):
                self.n_decode_on += 1
            elif d.decode_delta < 0 and self.n_decode_on > 1:
                self.n_decode_on -= 1
            self.router.n = self.n_prefill_on
            self.resize_events += 1
        # keep ticking only while the workload is live (same guard as churn)
        if (self.states or self.admission_queue
                or any(kind == "arrive" for _, _, kind, _ in self.events)):
            self._push(t + self.autoscaler.cfg.interval_s,
                       "autoscale_tick", None)

    def _on_decode_start(self, t, payload):
        wid, st, inv, rec = payload
        dw = self.decode[wid]
        finished = dw.advance(t)
        for rid, r in finished:
            self._decode_finished(t, r)
        rid = (st.session.sid, st.inv_idx)
        # variable-length finishes (the engine's eos/stop semantics): the
        # realized length is geometric-truncated, so a cut-short generation
        # releases its batch slot and resident KV to the fluid model early
        gen = inv.gen_tokens
        if self.scfg.eos_prob > 0:
            # numpy's geometric already returns >= 1 (trials to first
            # success), i.e. exactly "length at which the per-token stop
            # chance first fires"
            gen = min(gen, int(self.rng.geometric(self.scfg.eos_prob)))
            rec.finish_reason = "eos" if gen < inv.gen_tokens else "length"
        rec.gen_tokens = gen
        dw.active[rid] = {"remaining": float(gen),
                          "kv_len": float(len(st.context)),
                          "meta": (st, inv, rec)}
        rec.ttft = t + dw.itl() - rec.issued        # first token after one step
        self._ttft_window.append(rec.ttft)          # autoscaler p95 signal
        self._maybe_swap(t, dw)
        self._reschedule(t, dw)

    def _maybe_swap(self, t, dw: _DecodeWorker):
        """Preempt decode HBM overflow into the host swap tier.

        With ``overcommit > 1`` armed, a worker whose resident KV exceeds the
        HBM budget swaps the excess out at ``swap_gbps`` instead of paying the
        B.2 staging inflation forever: progress freezes for the transfer (the
        engine's gather and host copy), after which the remaining resident set
        decodes at un-inflated speed. Uses the churn-stall idiom — ``last_t``
        is parked in the future and ``advance()`` clamps on dt <= 0."""
        if self.scfg.overcommit <= 1.0 or self.scfg.swap_gbps <= 0:
            return
        # finished sequences take their swapped share with them (the engine
        # discards a finished victim's host entry)
        dw.swapped_bytes = min(dw.swapped_bytes, dw.resident_bytes())
        free = dw.hbm - dw.weight_bytes
        excess = dw.resident_bytes() - dw.swapped_bytes - free
        # hysteresis (the engine's PreemptConfig.hysteresis_steps): per-token
        # residency growth accumulates until it is worth one batched swap,
        # instead of counting a "preemption" every completion check
        if excess <= 0.02 * free:
            return
        stall = excess / (self.scfg.swap_gbps * 1e9)
        dw.swapped_bytes += excess
        dw.last_t = max(dw.last_t, t + stall)
        self.preemptions += 1
        self.swap_stall_s += stall
        # NO _reschedule here: both call sites reschedule right after, and a
        # second push per check would double the event stream every step

    def _reschedule(self, t, dw: _DecodeWorker):
        nxt = dw.next_completion(t)
        if nxt is not None:
            self._push(nxt, "decode_check", dw.wid)

    def _on_decode_check(self, t, wid):
        dw = self.decode[wid]
        finished = dw.advance(t)
        for rid, r in finished:
            self._decode_finished(t, r)
        self._maybe_swap(t, dw)
        self._reschedule(t, dw)

    def _decode_finished(self, t, r):
        st, inv, rec = r["meta"]
        rec.done = t
        # REALIZED generated tokens join the shared context (an eos-cut
        # generation contributes its shorter output, like the real engine)
        st.context += st.session.fresh_tokens(rec.gen_tokens,
                                              salt=2 + st.inv_idx * 2)
        self.t_end = max(self.t_end, t)
        self._next_invocation(t, st)

    def _finish_session(self, t, st: _SessionState):
        del self.states[st.session.sid]
        self.admitted -= 1
        self.b2.release(st.session.sid)
        self.completed_sessions.append((st.session.sid, st.started, t))
        while (self.admission_queue and self.admitted < self.effective_cap
               and self.b2.try_reserve(self.admission_queue[0].sid)):
            self._admit(t, self.admission_queue.pop(0))

    # -- metrics ---------------------------------------------------------
    def summary(self) -> dict:
        recs = [r for r in self.records if r.done > 0]
        sess = self.completed_sessions
        e2e = [done - start for _, start, done in sess]
        ttft = [r.ttft for r in recs]
        total_gen = sum(r.gen_tokens for r in recs)
        makespan = self.t_end - min(s.arrival for s in self.sessions)
        # fleet-wide hit accounting through the SAME rollup the engine's
        # ``stats()`` surface uses, so sim and engine report one number
        agg = CacheStats.merge(w.mgr.stats for w in self.prefill)
        hits, tot = agg.hit_tokens, agg.total_tokens
        return {
            "mode": self.scfg.mode,
            "sessions_done": len(sess),
            "p50_e2e_s": float(np.percentile(e2e, 50)) if e2e else float("nan"),
            "p95_e2e_s": float(np.percentile(e2e, 95)) if e2e else float("nan"),
            "mean_ttft_s": float(np.mean(ttft)) if ttft else float("nan"),
            "p95_ttft_s": float(np.percentile(ttft, 95)) if ttft else float("nan"),
            "throughput_tok_s": total_gen / makespan if makespan > 0 else 0.0,
            "prefix_hit_ratio": hits / tot if tot else 0.0,
            "prefill_busy_frac": float(np.mean(
                [w.busy_time / makespan for w in self.prefill])),
            "evictions": sum(w.mgr.pool.stats.evictions for w in self.prefill),
            "staged_frac": float(np.mean([r.staged for r in recs])) if recs else 0.0,
            "early_stop_frac": float(np.mean(
                [r.finish_reason == "eos" for r in recs])) if recs else 0.0,
            "churn_events": self.churn_events,
            "churn_stall_s": self.churn_stall_s,
            "resize_events": self.resize_events,
            "preemptions": self.preemptions,
            "swap_stall_s": self.swap_stall_s,
            "final_prefill_workers": self.n_prefill_on,
            "final_decode_workers": self.n_decode_on,
        }
