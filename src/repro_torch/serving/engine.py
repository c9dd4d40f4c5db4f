"""Disaggregated serving engine on the paged KV data plane.

Port of ``repro.serving.engine`` for the paper's main path: one frozen base
model prefills a shared prompt into a paged KV pool, and several
task-specific decode models read that KV with no copy.

  - prefill (eager): the router picks a prefill worker; its CacheManager
    matches the longest cached prefix in the engine-global radix tree and
    allocates pages for the rest; ``base_prefill_paged`` gathers the prefix
    out of the pool, extends it with the base model and writes the fresh
    rows back with the ``paged_write`` kernel. The allocation is held for
    the session (released by ``end_session``).
  - handoff: ZERO-COPY. The decode sequence takes a block-table reference
    and a refcount on every page; a partially filled tail page is cloned
    first (copy-on-write) so concurrent decoders append privately.
  - decode: every active sequence of every decode model advances one token
    per engine step in ONE forward over the stacked decoder weights
    (``serving.decode``; ``fused=False`` runs one forward per model), with
    attention by the ``paged_decode`` kernel and the new K/V appended to
    private pages. Greedy (temperature 0) tokens.
  - finish: pages are released; with relay on, a relay-compatible
    decoder's decode-written pages are published into the radix tree keyed
    by the full token stream, so a later prompt that extends it starts
    prefill past the finished output.

``LocalDisaggEngine(..., device=None)`` runs on the card; pass
``device="cpu"`` for the plain PyTorch versions of the kernels. Options that
later port slices bring raise ``NotImplementedError`` naming the slice.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.prefillshare import base_prefill_paged, cache_schema
from repro_torch.device import resolve_device
from repro_torch.kvcache.blocks import BlockPool, PoolExhausted
from repro_torch.kvcache.handoff import HandoffChannel
from repro_torch.kvcache.manager import CacheManager, CacheStats
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.kvcache.radix import NullPrefixIndex, PrefixIndex
from repro_torch.models import forward
from repro_torch.params import tree_leaves
from repro_torch.serving.api import (FINISH_ABORT, FINISH_LENGTH,
                                     RequestOutput, SamplingParams,
                                     SharedContext)
from repro_torch.serving.backpressure import ThroughputEWMA
from repro_torch.serving.decode import FusedDecodePlane, next_pow2
from repro_torch.serving.registry import ModelRegistry, as_spec
from repro_torch.serving.router import PrefillRouter
from repro_torch.serving.scheduler import ChunkedScheduler


def _sync(device: torch.device) -> None:
    """Wait for the card, so host clocks around device work measure it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class PagedSession:
    alloc: object                 # CacheManager Allocation, held for lifetime
    block_table: list             # physical page per logical page
    n_tokens: int
    tokens: list                  # context (for the sibling fast path)


@dataclass
class DecodeSeq:
    """One in-flight generation: a block-table reference into the shared
    pool (zero-copy handoff) plus private pages for generated tokens."""
    rid: int
    sid: int
    model_id: str
    block_table: list
    shared_blocks: list           # refcounted prefix pages (unref on finish)
    private_blocks: list          # CoW tail + generated pages (drop on finish)
    pos: int                      # tokens currently in the cache
    next_token: int               # token whose KV the next step writes
    remaining: int
    params: SamplingParams = field(default_factory=SamplingParams)
    finish_reason: str | None = None   # set on eos/stop; None -> length
    out: list = field(default_factory=list)
    tokens: list = field(default_factory=list)  # prompt (relay keys pages
                                                # by the full stream)
    first0: int = 2               # the handoff's first decode input token


@dataclass
class EngineStats:
    """Engine counters (plain integers; the metrics registry and its
    Prometheus export arrive with the serving-features slice)."""
    prefill_tokens_computed: int = 0
    prefill_tokens_reused: int = 0
    handoffs: int = 0
    handoff_bytes: int = 0
    cow_page_copies: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0
    decode_dispatches: int = 0
    model_churn_events: int = 0
    plane_rebuilds: int = 0
    relay_publishes: int = 0
    relay_pages_published: int = 0
    relay_skipped: int = 0
    _engine: object = field(default=None, repr=False, compare=False)

    @property
    def hit_ratio(self) -> float:
        tot = self.prefill_tokens_computed + self.prefill_tokens_reused
        return self.prefill_tokens_reused / tot if tot else 0.0

    @property
    def decode_batch_mean(self) -> float:
        return self.decode_tokens / self.decode_steps if self.decode_steps else 0.0

    def __call__(self) -> dict:
        """ONE engine-wide stats surface: the counters, plus the per-worker
        prefix-hit accounting rolled up (``CacheStats.merge``) and the
        pool's occupancy."""
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if not f.name.startswith("_")}
        d["hit_ratio"] = self.hit_ratio
        d["decode_batch_mean"] = self.decode_batch_mean
        eng = self._engine
        if eng is None:
            return d
        agg = CacheStats.merge(w.mgr.stats for w in eng.prefill_workers)
        pool = eng.block_pool
        d.update(prefix_hit_tokens=agg.hit_tokens,
                 prefix_total_tokens=agg.total_tokens,
                 prefix_lookups=agg.lookups,
                 prefix_hit_ratio=agg.hit_ratio,
                 relay_hit_tokens=agg.relay_hit_tokens,
                 relay_hit_ratio=(agg.relay_hit_tokens / agg.total_tokens
                                  if agg.total_tokens else 0.0),
                 evictions=pool.stats.evictions,
                 pages_active=pool.active_count,
                 pages_cached=pool.cached_count,
                 relay_nodes=eng.prefix_index.relay_nodes,
                 prefix_nodes=len(eng.prefix_index))
        return d


# ======================================================================
# Prefill workers


class PrefillWorker:
    """Paged prefill worker: frozen base model + CacheManager over the
    engine's SHARED page pool and SHARED radix tree, so a prefix published
    by any worker is a hit on every worker."""

    def __init__(self, cfg: ModelConfig, base_params, kvpool: PagedKVPool,
                 block_pool: BlockPool, stats: EngineStats, index=None):
        self.cfg = cfg
        self.base_params = base_params
        self.kvpool = kvpool
        self.mgr = CacheManager(cfg, block_pool.num_blocks,
                                block_pool.block_size, pool=block_pool,
                                index=index)
        self.sessions: dict[int, PagedSession] = {}
        self.stats = stats
        self.backlog_s = 0.0      # router load signal (estimated work issued)
        self.last_decay_t = time.monotonic()   # backlog decay clock
        self.ewma = ThroughputEWMA()       # measured prefill s/token

    def prefill(self, sid: int, tokens) -> tuple[list, int]:
        """Ensure pool pages cover ``tokens``; compute only the uncached
        tail. Returns (block_table, n_tokens)."""
        tokens = [int(t) for t in tokens]
        n = len(tokens)
        sc = self.sessions.get(sid)
        if sc is not None and sc.tokens == tokens:
            # sibling request over the identical context: the session's
            # pages already hold it, no acquire, no recompute
            self.mgr.record_hit(n)
            self.stats.prefill_tokens_reused += n
            return list(sc.block_table), n
        alloc = self.mgr.acquire(tokens)
        n_cached = alloc.cached_tokens
        bt = list(alloc.blocks)
        try:
            if n_cached < n:
                dev = self.kvpool.device
                new = torch.tensor([tokens[n_cached:]], dtype=torch.int32,
                                   device=dev)
                t0 = time.perf_counter()
                base_prefill_paged(self.cfg, self.base_params, new,
                                   pool=self.kvpool, block_table=bt,
                                   n_cached=n_cached)
                _sync(dev)                 # the router's EWMA needs real time
                self.ewma.observe(n - n_cached, time.perf_counter() - t0)
        except BaseException:
            # nothing was committed: tail pages hold partial KV and are
            # hard-freed, cached prefix refs go back
            self.mgr.abandon(alloc)
            raise
        self.mgr.commit(tokens, alloc)
        if sc is not None:
            self.mgr.release(sc.alloc)     # the new alloc holds the pages
        self.sessions[sid] = PagedSession(alloc, bt, n, tokens)
        self.stats.prefill_tokens_computed += n - n_cached
        self.stats.prefill_tokens_reused += n_cached
        self.backlog_s += (n - n_cached) * self.ewma.s_per_token
        return bt, n

    def end_session(self, sid: int):
        sc = self.sessions.pop(sid, None)
        if sc is not None:
            self.mgr.release(sc.alloc)     # pages -> CACHED (LRU, reusable)


# ======================================================================
# Decode


class DecodeWorker:
    """ONE task-specific decode module: its spec, the schema it was trained
    against, and the per-model step of the ``fused=False`` path."""

    #: may this model's decode-written KV be relay-published? Set by the
    #: engine at attach time (KV path identical to the frozen base).
    relay_compatible = False

    def __init__(self, cfg: ModelConfig, model_id: str, spec,
                 expected_schema):
        self.cfg = cfg
        self.model_id = model_id
        self.spec = as_spec(spec)
        self.expected_schema = expected_schema

    @torch.no_grad()
    def step(self, tokens, pos, cache):
        """One batched greedy decode step over a paged cache: feed
        ``tokens`` (B,) at positions ``pos`` (B,); the pool pages in
        ``cache`` are written in place. Returns next tokens (B,)."""
        logits, _ = forward(self.cfg, self.spec.full, tokens[:, None],
                            cache=cache, pos=pos)
        return logits.argmax(-1)


# ======================================================================
# Engine


def _param_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _param_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _param_paths(x, prefix + (i,))
    else:
        yield prefix, tree


class LocalDisaggEngine:
    """Prefill worker pool + decode models over one shared paged KV plane
    (eager prefill, zero-copy handoff, fused decode)."""

    def __init__(self, cfg: ModelConfig, base_params, decoders: dict | None = None,
                 *, device=None, capacity: int = 512, paged: bool | None = None,
                 num_pages: int = 1024, page_size: int = 16,
                 n_prefill_workers: int = 1, router_policy: str = "pinned",
                 chunked: bool = False, fused: bool | None = None,
                 prefix_cache: bool = True, relay: bool = True,
                 autoscale=None, sanitize: bool = False,
                 preempt: bool = False):
        self.device = resolve_device(device)
        if chunked:
            raise NotImplementedError("chunked prefill (chunked=True): "
                                      "port slice 2")
        if autoscale is not None:
            raise NotImplementedError("autoscale: port slice 4 "
                                      "(serving features)")
        if preempt:
            raise NotImplementedError("preempt=True: port slice 4 "
                                      "(serving features)")
        if sanitize:
            raise NotImplementedError("sanitize=True: port slice 7 "
                                      "(simulator and tools)")
        if paged is False or not PagedKVPool.supports(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the dense (non-paged) fallback: port slice 5")
        leaf = tree_leaves(base_params)[0]
        if leaf.device != self.device:
            raise ValueError(f"base_params live on {leaf.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.base_params = base_params
        self.page_size = page_size
        self.stats = EngineStats(_engine=self)
        self.schema = cache_schema(cfg, base_params, capacity)
        self.handoff = HandoffChannel(cfg)
        self.router = PrefillRouter(n_prefill_workers, router_policy)
        self.prefix_cache = prefix_cache
        # relay rides on the prefix tree: with prefix_cache=False the Null
        # index adopts nothing, so relay is off by construction
        self.relay = relay and prefix_cache
        self.block_pool = BlockPool(num_pages, page_size)
        self.kvpool = PagedKVPool(cfg, num_pages, page_size,
                                  device=self.device)
        if prefix_cache:
            # ONE engine-global radix tree shared by every worker's manager;
            # its eviction callback is registered exactly once, here
            self.prefix_index = PrefixIndex(page_size)
            self.block_pool.add_evict_callback(self.prefix_index.remove_block)
        else:
            self.prefix_index = NullPrefixIndex(page_size)
        self.prefill_workers = [
            PrefillWorker(cfg, base_params, self.kvpool, self.block_pool,
                          self.stats, index=self.prefix_index)
            for _ in range(n_prefill_workers)]
        self.fused = True if fused is None else fused
        self.scheduler = ChunkedScheduler(self)
        self.decoders: dict[str, DecodeWorker] = {}
        self.models = ModelRegistry(self)
        self.decode_plane = None
        for mid, params in (decoders or {}).items():
            self.models.register(mid, params)
        if self.fused:
            self._rebuild_decode_plane()
        self.models._dirty = False
        self.stats.model_churn_events = 0     # construction is not churn
        self._requests: dict[int, RequestOutput] = {}
        self._ephemeral_sids: dict[int, int] = {}      # rid -> auto session
        self._done: set[int] = set()                   # finished or aborted
        self._next_rid = 0
        self._next_ctx_sid = 1 << 40

    #: half-life of the issued-work router signal, in seconds of wall time
    BACKLOG_HALFLIFE_S = 0.25

    # ------------------------------------------------------------------
    def _pick_worker(self, sid: int, tokens=None, now: float | None = None):
        """Route by recency-weighted issued work priced at each worker's
        measured s/token, plus (``prefix_aware``) the request's cold tokens
        and the measured handoff estimate. Eager prefill is synchronous, so
        no worker has queued chunk work."""
        now = time.monotonic() if now is None else now
        for w in self.prefill_workers:
            dt = now - w.last_decay_t
            if dt > 0:
                w.backlog_s *= 0.5 ** (dt / self.BACKLOG_HALFLIFE_S)
                w.last_decay_t = now
        backlogs = [w.backlog_s for w in self.prefill_workers]
        cold_s = None
        if tokens is not None:
            n = len(tokens)
            cold_s = []
            for w in self.prefill_workers:
                sc = w.sessions.get(sid)
                if sc is not None and sc.tokens == tokens:
                    cold = 0
                else:
                    cold = n - w.mgr.index.match_len(tokens)
                cold_s.append(w.ewma.backlog_seconds(cold))
        picked = self.router.pick(sid, now, backlogs, cold_s,
                                  handoff_s=self.handoff.estimate_paged_s())
        return self.prefill_workers[picked]

    # ------------------------------------------------------------------
    # model lifecycle (driven by ModelRegistry)
    # ------------------------------------------------------------------
    #: top-level param subtrees that never feed a KV row: a decoder that
    #: differs from the base ONLY here writes KV identical to the base's
    _KV_NEUTRAL_KEYS = ("unembed", "final_norm")

    def _relay_compatible(self, spec) -> bool:
        """May ``spec``'s decode-written KV be republished as shared prefix?
        Only if its KV path is the frozen base model's: the base weights
        themselves, or equal to them outside the KV-neutral leaves."""
        if spec.full is self.base_params:
            return True
        base = list(_param_paths(self.base_params))
        dec = list(_param_paths(spec.full))
        if [p for p, _ in base] != [p for p, _ in dec]:
            return False
        for (path, lb), (_, ld) in zip(base, dec):
            if path[0] in self._KV_NEUTRAL_KEYS or lb is ld:
                continue
            if lb.shape != ld.shape or not torch.equal(lb, ld):
                return False
        return True

    def _attach_decoder(self, model_id: str, spec) -> None:
        """Registry hook: make ``model_id`` servable now (the fused plane
        picks it up at the next step boundary)."""
        leaf = tree_leaves(as_spec(spec).full)[0]
        if leaf.device != self.device:
            raise ValueError(f"decoder {model_id!r} lives on {leaf.device}, "
                             f"the engine on {self.device}")
        dw = DecodeWorker(self.cfg, model_id, spec, self.schema)
        dw.relay_compatible = self._relay_compatible(dw.spec)
        self.decoders[model_id] = dw

    def _detach_decoder(self, model_id: str) -> None:
        self.decoders.pop(model_id, None)

    def _rebuild_decode_plane(self) -> None:
        """Relayout the fused plane to the registry's CURRENT model set (at
        step boundaries, plus once at construction). The dispatch counter
        carries across rebuilds."""
        if not self.fused:
            return
        old = self.decode_plane
        self.decode_plane = FusedDecodePlane(
            {mid: (self.cfg, spec)
             for mid, spec in self.models._specs.items()},
            self.kvpool,
            dispatches0=old.dispatches if old is not None else 0)
        if old is not None:
            self.stats.plane_rebuilds += 1

    def _has_inflight(self, model_id: str) -> bool:
        return any(s.model_id == model_id for s in self.scheduler.active)

    def _inflight_rids(self, model_id: str) -> list[int]:
        return [s.rid for s in self.scheduler.active
                if s.model_id == model_id]

    # ------------------------------------------------------------------
    def _handoff_seq(self, block_table, n: int, sid: int, model_id: str,
                     params: SamplingParams, first_token: int,
                     rid: int, tokens=None) -> DecodeSeq:
        """Zero-copy handoff: block-table reference + page refcounts, with a
        copy-on-write clone of a partially filled tail page so the decode
        sequence can append privately. Raises PoolExhausted (with the
        handoff refs rolled back) if the clone page cannot be allocated."""
        dw = self.decoders[model_id]
        HandoffChannel.check(self.schema, dw.expected_schema)
        t0 = time.perf_counter()
        bt = list(block_table)
        self.block_pool.ref(bt)
        shared, private = list(bt), []
        if n % self.page_size:
            # the partial tail page is shared with the prefill session (and
            # any sibling decoder): clone it so this sequence can append
            last = bt[-1]
            try:
                [fresh] = self.block_pool.alloc(1)
            except PoolExhausted:
                self.block_pool.unref(bt)      # roll back the handoff refs
                raise
            self.kvpool.copy_page(last, fresh)
            self.block_pool.unref([last])
            shared.pop()
            private.append(fresh)
            bt = bt[:-1] + [fresh]
            self.stats.cow_page_copies += 1
        plan = self.handoff.plan_paged(len(bt))
        self.handoff.observe_paged(plan.bytes, time.perf_counter() - t0)
        self.stats.handoffs += 1
        self.stats.handoff_bytes += plan.bytes         # metadata only
        return DecodeSeq(rid, sid, model_id, bt, shared, private, n,
                         first_token, params.max_tokens, params,
                         tokens=list(tokens) if tokens is not None else [],
                         first0=first_token)

    def _submit(self, rid: int, sid: int, tokens: list, model_id: str,
                params: SamplingParams, first_token: int) -> None:
        """Eager mode: whole-prompt prefill and handoff, synchronously and
        in call order (so a request's priority has no effect).
        ``max_tokens == 0`` is prefill-only: the prompt becomes resident
        (and published for prefix reuse), no decode."""
        worker = self._pick_worker(sid, tokens)
        bt, n = worker.prefill(sid, tokens)
        if params.max_tokens == 0:
            self._on_request_done(rid, FINISH_LENGTH)
            return
        self.scheduler.add_decode_seq(self._handoff_seq(
            bt, n, sid, model_id, params, first_token, rid, tokens=tokens))

    # ------------------------------------------------------------------
    # request-centric API (repro_torch.serving.api)
    # ------------------------------------------------------------------
    def generate(self, model_id: str, tokens,
                 params: SamplingParams | None = None, *,
                 session: int | None = None, priority: int = 0,
                 first_token: int = 2, stream_callback=None) -> RequestOutput:
        """Prefill ``tokens`` (eagerly, now), hand the request to decode
        model ``model_id`` and return its streaming ``RequestOutput``.

        ``session=None`` runs the request in an engine-owned one-shot
        session, released when the request finishes or is aborted. Pass a
        ``SharedContext``'s session (via ``ctx.generate``) to attach to a
        shared prefix. Iterate the handle / call ``result()`` to drive the
        engine, or drive it with ``run()``/``step()``. ``priority`` is
        accepted for the API's sake; eager mode serves in call order."""
        self.models.check_serving(model_id)
        params = SamplingParams() if params is None else params
        if params.temperature > 0:
            raise NotImplementedError("sampling (temperature > 0): port "
                                      "slice 3")
        ephemeral = session is None
        sid = self._new_context_sid() if ephemeral else session
        rid = self._next_rid
        self._next_rid += 1
        out = RequestOutput(self, rid, sid, model_id, params)
        if stream_callback is not None:
            out.add_callback(stream_callback)
        self._requests[rid] = out
        if ephemeral:
            self._ephemeral_sids[rid] = sid
        try:
            self._submit(rid, sid, [int(t) for t in np.asarray(tokens)],
                         model_id, params, first_token)
        except Exception:
            # prefill can raise (PoolExhausted) after the handle was
            # registered: unwind so retries leak no orphan handles
            self._requests.pop(rid, None)
            self._ephemeral_sids.pop(rid, None)
            raise
        return out

    def shared_context(self, prefix_tokens=(), *,
                       prefill: bool = True) -> SharedContext:
        """Open a first-class shared prefix: one prefilled context that
        many ``ctx.generate(model_id, tail)`` calls attach to. Use as a
        context manager; exit releases the pages."""
        return SharedContext(self, prefix_tokens, prefill=prefill)

    def abort(self, request) -> bool:
        """Cancel a request. Accepts a ``RequestOutput`` or a request id.
        Returns True if the request was still live. In eager mode a live
        request is decoding: its handoff refs and private pages are
        released, so the pool's free-page count returns exactly to its
        pre-request baseline."""
        rid = request.request_id if isinstance(request, RequestOutput) \
            else int(request)
        if rid in self._done:
            return False
        sched = self.scheduler
        for s in sched.active:
            if s.rid != rid:
                continue
            if s.remaining <= 0:
                return False   # complete, awaiting the next step's reap
            sched.active.remove(s)
            self.block_pool.unref(s.shared_blocks)
            self.block_pool.drop(s.private_blocks)
            self._on_request_done(rid, FINISH_ABORT)
            return True
        return False

    def _new_context_sid(self) -> int:
        sid = self._next_ctx_sid
        self._next_ctx_sid += 1
        return sid

    def _prefill_context(self, sid: int, tokens) -> None:
        """Make ``tokens`` resident for session ``sid`` (SharedContext)."""
        tokens = [int(t) for t in tokens]
        self._pick_worker(sid, tokens).prefill(sid, tokens)

    def _on_request_done(self, rid: int, reason: str) -> None:
        self._done.add(rid)
        out = self._requests.pop(rid, None)
        if out is not None:
            out._mark_finished(reason)
        sid = self._ephemeral_sids.pop(rid, None)
        if sid is not None:
            self.end_session(sid)                  # one-shot session cleanup

    def run(self) -> None:
        """Drive the scheduler until every request finishes."""
        self.scheduler.run()

    def step(self) -> None:
        """One scheduler step."""
        self.scheduler.step()

    def _grow_tail_pages(self, seqs: list[DecodeSeq]) -> None:
        page = self.page_size
        for s in seqs:                       # grow private tail pages
            if s.pos >= len(s.block_table) * page:
                [fresh] = self.block_pool.alloc(1)
                s.block_table.append(fresh)
                s.private_blocks.append(fresh)

    def decode_step(self, seqs: list[DecodeSeq]) -> None:
        """Advance every active sequence, across ALL decode models, one
        greedy token: ONE fused forward per step (``fused=False``: one per
        model). Streams each token to its request handle and retires
        sequences that emit their eos/stop token on the next reap."""
        if not seqs:
            return
        self._grow_tail_pages(seqs)
        if self.decode_plane is not None:
            before = self.decode_plane.dispatches
            nxt = self.decode_plane.step(seqs)
            self.stats.decode_dispatches += self.decode_plane.dispatches - before
        else:
            nxt = [0] * len(seqs)
            by_model: dict[str, list] = {}
            for i, s in enumerate(seqs):
                by_model.setdefault(s.model_id, []).append(i)
            for mid, idx in by_model.items():
                toks = self._batched_step(mid, [seqs[i] for i in idx])
                for i, t in zip(idx, toks):
                    nxt[i] = t
        for s, t in zip(seqs, nxt):
            s.out.append(t)
            s.next_token = t
            s.pos += 1
            s.remaining -= 1
            out = self._requests.get(s.rid)
            if out is not None:
                out._push(t)
            reason = s.params.is_stop(t)
            if reason is not None:
                s.finish_reason = reason
                s.remaining = 0                    # retired next reap
        self.stats.decode_steps += 1
        self.stats.decode_tokens += len(seqs)

    def _batched_step(self, mid: str, seqs: list[DecodeSeq]) -> list:
        """One per-model forward (the ``fused=False`` dispatch unit);
        returns greedy next tokens aligned with ``seqs``."""
        # pow2-bucket the table width: padded columns lie past every
        # sequence's length, so this is token-identical
        npages = next_pow2(max(len(s.block_table) for s in seqs))
        bt = np.zeros((len(seqs), npages), np.int32)
        for i, s in enumerate(seqs):
            bt[i, :len(s.block_table)] = s.block_table
        dev = self.device
        toks = torch.tensor([s.next_token for s in seqs], dtype=torch.int32,
                            device=dev)
        pos = torch.tensor([s.pos for s in seqs], dtype=torch.int32,
                           device=dev)
        pool_cache = self.kvpool.make_decode_cache(torch.from_numpy(bt).to(dev))
        nxt = self.decoders[mid].step(toks, pos, pool_cache)
        self.stats.decode_dispatches += 1
        return nxt.cpu().tolist()

    def _relay_publish(self, s: DecodeSeq) -> set:
        """Publish a FINISHED sequence's resident KV into the radix tree,
        keyed by its full token stream (prompt, first decode input,
        generated tokens bar the last, whose KV was never written). Returns
        the page ids the tree adopted. Only relay-compatible decoders
        publish."""
        if not (self.relay and s.tokens and s.out):
            return set()
        dw = self.decoders.get(s.model_id)
        if dw is None or not dw.relay_compatible:
            self.stats.relay_skipped += 1
            return set()
        # position p holds the KV of the token INPUT at p; only full pages
        # are indexable
        stream = list(s.tokens) + [s.first0] + [int(t) for t in s.out[:-1]]
        full = s.pos // self.page_size
        adopted = set(self.prefix_index.insert_pages(
            stream, s.block_table[:full], provenance="relay"))
        if adopted:
            self.stats.relay_publishes += 1
            self.stats.relay_pages_published += len(adopted)
        return adopted

    def _finish(self, s: DecodeSeq) -> None:
        adopted = self._relay_publish(s)
        self.block_pool.unref(s.shared_blocks)   # freed only w/ last holder
        if adopted:
            # relay-published pages stay resident (CACHED, tree-served);
            # duplicates and the partial tail are dropped as before
            self.block_pool.unref([b for b in s.private_blocks
                                   if b in adopted])
            self.block_pool.drop([b for b in s.private_blocks
                                  if b not in adopted])
        else:
            self.block_pool.drop(s.private_blocks)   # generated KV: private
        self._on_request_done(s.rid, s.finish_reason or FINISH_LENGTH)

    def end_session(self, sid: int):
        for w in self.prefill_workers:
            w.end_session(sid)
