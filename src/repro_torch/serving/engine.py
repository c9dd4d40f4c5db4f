"""Disaggregated serving engine on the paged KV data plane.

Port of ``repro.serving.engine`` for the paper's main path: one frozen base
model prefills a shared prompt into a paged KV pool, and several
task-specific decode models read that KV with no copy.

  - prefill, eager (default): the router picks a prefill worker; its
    CacheManager matches the longest cached prefix in the engine-global
    radix tree and allocates pages for the rest; ``base_prefill_paged``
    gathers the prefix out of the pool, extends it with the base model and
    writes the fresh rows back with the ``paged_write`` kernel. The
    allocation is held for the session (released by ``end_session``).
  - prefill, chunked (``chunked=True``): requests queue in the token-budget
    scheduler (``serving.scheduler``), which admits them in policy order,
    grows their pages chunk by chunk and runs equal-length chunks as one
    ``base_prefill_chunk`` forward whose attention reads the prefix straight
    from the pages (the ``flash_prefill_paged`` kernel), interleaved with
    decode steps.
  - handoff: ZERO-COPY. The decode sequence takes a block-table reference
    and a refcount on every page; a partially filled tail page is cloned
    first (copy-on-write) so concurrent decoders append privately.
  - decode: every active sequence of every decode model advances one token
    per engine step in ONE forward over the stacked decoder weights
    (``serving.decode``; ``fused=False`` runs one forward per model), with
    attention by the ``paged_decode`` kernel and the new K/V appended to
    private pages. Tokens are sampled per request (``SamplingParams``;
    temperature 0 is exact greedy), keys folded from (seed, position).
  - finish: pages are released; with relay on, a relay-compatible
    decoder's decode-written pages are published into the radix tree keyed
    by the full token stream, so a later prompt that extends it starts
    prefill past the finished output.

Decode models are full fine-tunes (``DecodeModelSpec(full=...)``) or LoRA
adapters over the engine's base weights (``DecodeModelSpec(lora=...)``).
``metrics=True`` (the default) publishes latency histograms, gauges and
per-request traces into one ``MetricsRegistry`` (``engine.metrics()``,
``engine.render_prometheus()``); ``engine.stats`` is a view over its
counters either way.

``LocalDisaggEngine(..., device=None)`` runs on the card; pass
``device="cpu"`` for the plain PyTorch versions of the kernels. Options not
ported yet raise ``NotImplementedError`` naming the feature.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.prefillshare import base_prefill_paged, cache_schema
from repro_torch.device import resolve_device, synchronize
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
from repro_torch.serving.decode import (FusedDecodePlane, next_pow2,
                                        next_tokens)
from repro_torch.serving.metrics import (SPAN_FIRST_TOKEN, SPAN_HANDOFF,
                                         SPAN_ROUTED, SPAN_TOKEN,
                                         MetricsRegistry)
from repro_torch.serving.registry import ModelRegistry, as_spec
from repro_torch.serving.router import PrefillRouter
from repro_torch.serving.scheduler import (ChunkedScheduler, Request,
                                           SchedulerConfig)


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


class _CounterField:
    """EngineStats field backed by a registry ``Counter``: reads return
    ints, writes (``+= n``, ``= 0``) go to the counter cell, so
    ``engine.stats`` and ``engine.metrics()`` are the same numbers."""

    __slots__ = ("prom", "help", "name")

    def __init__(self, prom: str, help: str = ""):
        self.prom = prom
        self.help = help

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return int(obj._cells[self.name].value)

    def __set__(self, obj, v):
        obj._cells[self.name].value = float(v)


class EngineStats:
    """Engine counters, a VIEW over the metrics registry: each field is a
    registry counter cell (real even with metrics off)."""

    prefill_tokens_computed = _CounterField(
        "engine_prefill_tokens_computed_total",
        "prompt tokens actually run through the base prefill model")
    prefill_tokens_reused = _CounterField(
        "engine_prefill_tokens_reused_total",
        "prompt tokens served from cached prefix KV (never recomputed)")
    handoffs = _CounterField(
        "engine_handoffs_total", "prefill->decode cache handoffs")
    handoff_bytes = _CounterField(
        "engine_handoff_bytes_total",
        "handoff wire bytes (paged: block-table metadata only)")
    cow_page_copies = _CounterField(
        "engine_cow_page_copies_total",
        "partial tail pages cloned at handoff (page-level copy-on-write)")
    decode_steps = _CounterField(
        "engine_decode_steps_total", "engine decode steps")
    decode_tokens = _CounterField(
        "engine_decode_tokens_total", "tokens generated across all sequences")
    decode_dispatches = _CounterField(
        "engine_decode_dispatches_total", "decode forwards issued")
    model_churn_events = _CounterField(
        "engine_model_churn_events_total",
        "accepted register/unregister mutations")
    plane_rebuilds = _CounterField(
        "engine_plane_rebuilds_total",
        "fused-plane relayouts applied at step boundaries")
    relay_publishes = _CounterField(
        "engine_relay_publishes_total",
        "finished sequences whose decode KV entered the prefix tree")
    relay_pages_published = _CounterField(
        "engine_relay_pages_published_total",
        "decode-written pages adopted into the radix tree at finish")
    relay_skipped = _CounterField(
        "engine_relay_skipped_total",
        "finished sequences not published (relay-incompatible decoder)")

    FIELDS = ("prefill_tokens_computed", "prefill_tokens_reused", "handoffs",
              "handoff_bytes", "cow_page_copies", "decode_steps",
              "decode_tokens", "decode_dispatches", "model_churn_events",
              "plane_rebuilds", "relay_publishes", "relay_pages_published",
              "relay_skipped")

    def __init__(self, _engine: object = None,
                 registry: MetricsRegistry | None = None):
        self._engine = _engine
        self.registry = MetricsRegistry() if registry is None else registry
        cls = type(self)
        self._cells = {
            name: self.registry.counter(cls.__dict__[name].prom,
                                        cls.__dict__[name].help)
            for name in self.FIELDS}

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
        d = {name: getattr(self, name) for name in self.FIELDS}
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

    def __init__(self, wid: int, cfg: ModelConfig, base_params,
                 kvpool: PagedKVPool, block_pool: BlockPool,
                 stats: EngineStats, index=None):
        self.wid = wid                # index in the pool (trace spans)
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
        self.pending_chunk_tokens = 0      # admitted-but-uncomputed (chunked)

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
                synchronize(dev)           # the router's EWMA needs real time
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
    against, and the per-model step of the ``fused=False`` path. Its full
    weights materialize lazily: a LoRA spec pays for ``lora_apply`` only if
    the per-model path runs it; the fused plane reads the factors."""

    #: may this model's decode-written KV be relay-published? Set by the
    #: engine at attach time (KV path identical to the frozen base).
    relay_compatible = False

    def __init__(self, cfg: ModelConfig, model_id: str, spec,
                 expected_schema, base_params=None):
        self.cfg = cfg
        self.model_id = model_id
        self.spec = as_spec(spec)
        self.base_params = base_params
        self.expected_schema = expected_schema
        self._dec_params = None

    @property
    def dec_params(self):
        if self._dec_params is None:
            self._dec_params = self.spec.materialize(self.base_params)
        return self._dec_params

    @torch.no_grad()
    def step(self, seqs, kvpool) -> list:
        """Advance ``seqs`` (all of this model) one token in one batched
        forward over the paged pool, whose pages are written in place;
        returns the next tokens, sampled per their SamplingParams (greedy at
        temperature 0). Tail pages must already cover position ``pos``."""
        # pow2-bucket the table width: padded columns lie past every
        # sequence's length, so this is token-identical
        npages = next_pow2(max(len(s.block_table) for s in seqs))
        bt = np.zeros((len(seqs), npages), np.int32)
        for i, s in enumerate(seqs):
            bt[i, :len(s.block_table)] = s.block_table
        dev = kvpool.device
        toks = torch.tensor([s.next_token for s in seqs], dtype=torch.int32)
        pos = torch.tensor([s.pos for s in seqs], dtype=torch.int32).to(dev)
        cache = kvpool.make_decode_cache(torch.from_numpy(bt).to(dev))
        logits, _ = forward(self.cfg, self.dec_params, toks.to(dev)[:, None],
                            cache=cache, pos=pos)
        return next_tokens(logits, seqs, dev)


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
    (eager or chunked prefill, zero-copy handoff, fused decode)."""

    def __init__(self, cfg: ModelConfig, base_params, decoders: dict | None = None,
                 *, device=None, capacity: int = 512, paged: bool | None = None,
                 num_pages: int = 1024, page_size: int = 16,
                 n_prefill_workers: int = 1, router_policy: str = "pinned",
                 chunked: bool = False, token_budget: int = 256,
                 chunk_size: int = 64, sched_policy: str = "fcfs",
                 fused: bool | None = None, prefix_cache: bool = True,
                 relay: bool = True, metrics: bool = True, autoscale=None,
                 sanitize: bool = False, preempt: bool = False):
        self.device = resolve_device(device)
        if autoscale is not None:
            raise NotImplementedError("autoscaling (autoscale=...) is not "
                                      "ported yet")
        if preempt:
            raise NotImplementedError("preemption (preempt=True) is not "
                                      "ported yet")
        if sanitize:
            raise NotImplementedError("the pool sanitizer (sanitize=True) "
                                      "is not ported yet")
        if paged is False or not PagedKVPool.supports(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the dense (non-paged) fallback is not ported "
                f"yet")
        leaf = tree_leaves(base_params)[0]
        if leaf.device != self.device:
            raise ValueError(f"base_params live on {leaf.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.base_params = base_params
        self.page_size = page_size
        self.chunked = chunked
        # ONE registry the engine and scheduler publish into.
        # metrics=False degrades histograms/gauges/traces to shared no-op
        # singletons (the decode loop skips observation via _metrics_on);
        # counters stay real because stats() runs on them
        self._metrics_on = metrics
        self.metrics_registry = MetricsRegistry(enabled=metrics)
        self.stats = EngineStats(_engine=self,
                                 registry=self.metrics_registry)
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
            PrefillWorker(i, cfg, base_params, self.kvpool,
                          self.block_pool, self.stats,
                          index=self.prefix_index)
            for i in range(n_prefill_workers)]
        self.fused = True if fused is None else fused
        self.scheduler = ChunkedScheduler(
            self, SchedulerConfig(token_budget=token_budget,
                                  chunk_size=chunk_size,
                                  policy=sched_policy))
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
        self._next_seq = 0                             # arrival order
        self._next_ctx_sid = 1 << 40
        self._init_metrics()

    #: half-life of the issued-work router signal, in seconds of wall time
    BACKLOG_HALFLIFE_S = 0.25

    # ------------------------------------------------------------------
    def _pick_worker(self, sid: int, tokens=None, now: float | None = None):
        """Route by recency-weighted issued work plus (chunked mode) the
        admitted-but-uncomputed chunk backlog, both priced at each worker's
        measured s/token, plus (``prefix_aware``) the request's cold tokens
        and the measured handoff estimate."""
        now = time.monotonic() if now is None else now
        for w in self.prefill_workers:
            dt = now - w.last_decay_t
            if dt > 0:
                w.backlog_s *= 0.5 ** (dt / self.BACKLOG_HALFLIFE_S)
                w.last_decay_t = now
        backlogs = [w.backlog_s + w.ewma.backlog_seconds(w.pending_chunk_tokens)
                    for w in self.prefill_workers]
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
        if self._metrics_on:
            self._c_router_picks.inc()
            if picked != sid % len(self.prefill_workers):
                self._c_router_nonhome.inc()
        return self.prefill_workers[picked]

    # ------------------------------------------------------------------
    # observability (serving/metrics.py)
    # ------------------------------------------------------------------
    def _init_metrics(self) -> None:
        """Bind the engine's instruments: histograms up front (hot paths
        hold direct references), gauges as collectors sampled only at
        export time. Preemption, swap and autoscale instruments come with
        those features."""
        reg = self.metrics_registry
        self._h_ttft = reg.histogram(
            "engine_ttft_seconds", "submit -> first streamed token",
            lo=1e-5, hi=600.0)
        self._h_itl = reg.histogram(
            "engine_itl_seconds", "gap between consecutive streamed tokens",
            lo=1e-6, hi=60.0)
        self._h_queue = reg.histogram(
            "engine_queue_depth", "waiting+prefilling requests, per step",
            lo=1.0, hi=4096.0, growth=1.5)
        self._h_occ = reg.histogram(
            "engine_page_occupancy",
            "non-free pool page fraction, per step", lo=1e-3, hi=1.0)
        self._h_batch = reg.histogram(
            "engine_decode_batch", "sequences per decode step",
            lo=1.0, hi=4096.0, growth=1.5)
        self._h_handoff_s = reg.histogram(
            "engine_handoff_seconds",
            "measured prefill->decode handoff wall time", lo=1e-7, hi=10.0)
        self._h_handoff_b = reg.histogram(
            "engine_handoff_plan_bytes", "handoff metadata bytes",
            lo=1.0, hi=1e9, growth=2.0)
        self._c_router_picks = reg.counter(
            "engine_router_picks_total", "prefill routing decisions")
        self._c_router_nonhome = reg.counter(
            "engine_router_nonhome_picks_total",
            "routing decisions away from the session's home worker")
        reg.gauge("engine_prefill_workers", "live prefill workers",
                  fn=lambda: len(self.prefill_workers))
        reg.gauge("engine_waiting_requests", "requests awaiting admission",
                  fn=lambda: len(self.scheduler.waiting))
        reg.gauge("engine_prefilling_requests", "requests mid-prefill",
                  fn=lambda: len(self.scheduler.prefilling))
        reg.gauge("engine_active_sequences", "sequences decoding",
                  fn=lambda: len(self.scheduler.active))
        reg.gauge("engine_pool_free_pages", "free pool pages",
                  fn=lambda: self.block_pool.free_count)
        reg.gauge("engine_pool_active_pages", "refcount-held pool pages",
                  fn=lambda: self.block_pool.active_count)
        reg.gauge("engine_pool_cached_pages",
                  "LRU-cached (evictable) pool pages",
                  fn=lambda: self.block_pool.cached_count)
        reg.gauge("engine_prefix_nodes", "radix prefix-index nodes",
                  fn=lambda: len(self.prefix_index))
        reg.gauge("engine_relay_nodes",
                  "radix nodes holding decode-written (relay) KV",
                  fn=lambda: self.prefix_index.relay_nodes)

    def metrics(self) -> dict:
        """The observability surface as dicts: ``{"counters", "gauges",
        "histograms"}`` (histograms with count/sum/mean/min/max/p50/p95/p99)
        plus ``"traces"``, the retained per-request lifecycle traces."""
        out = self.metrics_registry.snapshot()
        out["traces"] = [t.as_dict() for t in self.metrics_registry.traces()]
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition of every registered metric (checked by
        ``metrics.lint_prometheus``)."""
        return self.metrics_registry.render_prometheus()

    def _observe_step(self) -> None:
        """Per-step queue-depth and pool-occupancy samples (the scheduler
        calls this at every step boundary); nothing when metrics are off."""
        if not self._metrics_on:
            return
        sched = self.scheduler
        self._h_queue.observe(len(sched.waiting) + len(sched.prefilling))
        pool = self.block_pool
        self._h_occ.observe(1.0 - pool.free_count / pool.num_blocks)

    # ------------------------------------------------------------------
    # model lifecycle (driven by ModelRegistry)
    # ------------------------------------------------------------------
    #: top-level param subtrees that never feed a KV row: a decoder that
    #: differs from the base ONLY here writes KV identical to the base's
    _KV_NEUTRAL_KEYS = ("unembed", "final_norm")

    def _relay_compatible(self, spec) -> bool:
        """May ``spec``'s decode-written KV be republished as shared prefix?
        Only if its KV path is the frozen base model's: the base weights
        themselves, or equal to them outside the KV-neutral leaves. LoRA
        adapters perturb the attention weights, so their KV is theirs
        alone."""
        if spec.full is None:
            return False
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
        spec = as_spec(spec)
        leaves = (tree_leaves(spec.full)[:1] if spec.full is not None
                  else tree_leaves(spec.lora.params))
        for leaf in leaves:
            if leaf.device != self.device:
                raise ValueError(f"decoder {model_id!r} lives on "
                                 f"{leaf.device}, the engine on "
                                 f"{self.device}")
        dw = DecodeWorker(self.cfg, model_id, spec, self.schema,
                          self.base_params)
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
            self.kvpool, self.base_params,
            dispatches0=old.dispatches if old is not None else 0)
        if old is not None:
            self.stats.plane_rebuilds += 1

    def _has_inflight(self, model_id: str) -> bool:
        """Any live work addressed to ``model_id`` (waiting, prefilling or
        decoding)? Gates drain completion and plane-lane retirement."""
        return bool(self._inflight_rids(model_id))

    def _inflight_rids(self, model_id: str) -> list[int]:
        sched = self.scheduler
        return ([r.rid for r in sched.waiting if r.model_id == model_id]
                + [r.rid for r in sched.prefilling if r.model_id == model_id]
                + [s.rid for s in sched.active if s.model_id == model_id])

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
        dt = time.perf_counter() - t0
        self.handoff.observe_paged(plan.bytes, dt)
        self.stats.handoffs += 1
        self.stats.handoff_bytes += plan.bytes         # metadata only
        if self._metrics_on:
            self._h_handoff_s.observe(dt)
            self._h_handoff_b.observe(plan.bytes)
            self.metrics_registry.trace(rid).event(
                SPAN_HANDOFF, bytes=plan.bytes, seconds=dt)
        return DecodeSeq(rid, sid, model_id, bt, shared, private, n,
                         first_token, params.max_tokens, params,
                         tokens=list(tokens) if tokens is not None else [],
                         first0=first_token)

    def _submit(self, rid: int, sid: int, tokens: list, model_id: str | None,
                params: SamplingParams, first_token: int,
                priority: int = 0) -> None:
        """Queue one request. Chunked mode: it enters the scheduler's
        admission queue and its prompt is prefilled in token-budget chunks
        interleaved with decode, admitted in ``priority`` order under the
        priority policy. Eager mode: whole-prompt prefill and handoff happen
        here, synchronously and in call order, so ``priority`` has no
        effect. ``max_tokens == 0`` is prefill-only: the prompt becomes
        resident (and published for prefix reuse), no decode."""
        # the lifecycle trace opens here (queued span); later stages append
        self.metrics_registry.start_trace(rid, model_id)
        if self.chunked:
            self.scheduler.add(Request(
                rid=rid, sid=sid, model_id=model_id, tokens=tokens,
                gen_tokens=params.max_tokens, first_token=first_token,
                priority=priority, seq=self._next_seq, params=params))
            self._next_seq += 1
            return
        worker = self._pick_worker(sid, tokens)
        self.metrics_registry.trace(rid).event(SPAN_ROUTED, worker=worker.wid)
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
        """Queue one generation for decode model ``model_id`` and return its
        streaming ``RequestOutput``. Eager mode prefills ``tokens`` now;
        chunked mode queues them for the scheduler.

        ``session=None`` runs the request in an engine-owned one-shot
        session, released when the request finishes or is aborted. Pass a
        ``SharedContext``'s session (via ``ctx.generate``) to attach to a
        shared prefix. Iterate the handle / call ``result()`` to drive the
        engine, or drive it with ``run()``/``step()``. ``priority`` (or
        ``params.priority``) orders admission under
        ``sched_policy="priority"`` in chunked mode; eager mode serves in
        call order. ``params.seed=None`` samples with the request id as its
        seed (distinct draws per request); pass a seed to reproduce a
        stream."""
        self.models.check_serving(model_id)
        params = SamplingParams() if params is None else params
        if not priority:
            priority = params.priority
        ephemeral = session is None
        sid = self._new_context_sid() if ephemeral else session
        rid = self._next_rid
        self._next_rid += 1
        params = self._resolve_seed(params, rid)   # the handle sees the seed
        out = RequestOutput(self, rid, sid, model_id, params)
        if stream_callback is not None:
            out.add_callback(stream_callback)
        self._requests[rid] = out
        if ephemeral:
            self._ephemeral_sids[rid] = sid
        try:
            self._submit(rid, sid, [int(t) for t in np.asarray(tokens)],
                         model_id, params, first_token, priority)
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
        """Cancel a request at any stage. Accepts a ``RequestOutput`` or a
        request id. Returns True if the request was still live (False:
        already finished, already aborted, unknown).

        Queued: removed before any pages are touched. Prefilling (including
        held under pool backpressure): its chunk-granular allocation is
        reclaimed; cached prefix pages return to the LRU cache, partially
        written tail pages are dropped. Decoding: its handoff refs and
        private pages are released. In every case the pool's free-page
        count returns exactly to its pre-request baseline."""
        rid = request.request_id if isinstance(request, RequestOutput) \
            else int(request)
        if rid in self._done:
            return False
        sched = self.scheduler
        for r in sched.waiting:                    # queued: nothing held yet
            if r.rid == rid:
                sched.waiting.remove(r)
                self._on_request_done(rid, FINISH_ABORT)
                return True
        for r in sched.prefilling:                 # mid-chunk / held
            if r.rid != rid:
                continue
            sched.prefilling.remove(r)
            if r.sibling_bt is not None:
                self.block_pool.unref(r.sibling_bt)   # drop the sibling pin
            elif not r.committed:   # committed: the session owns the pages
                r.worker.mgr.abandon(r.alloc)
                r.worker.pending_chunk_tokens -= r.n - r.done
            self._on_request_done(rid, FINISH_ABORT)
            return True
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

    @staticmethod
    def _resolve_seed(params: SamplingParams, rid: int) -> SamplingParams:
        """``seed=None`` -> the request id, so N sampled fan-outs over one
        prompt draw differently; an explicit seed passes through."""
        if params.seed is not None:
            return params
        return dataclasses.replace(params, seed=rid)

    def _new_context_sid(self) -> int:
        sid = self._next_ctx_sid
        self._next_ctx_sid += 1
        return sid

    def _prefill_context(self, sid: int, tokens) -> None:
        """Make ``tokens`` resident for session ``sid`` (SharedContext
        warm-up). Eager mode prefills synchronously; chunked mode drives the
        scheduler until the prefill-only request completes."""
        tokens = [int(t) for t in tokens]
        if not self.chunked:
            self._pick_worker(sid, tokens).prefill(sid, tokens)
            return
        rid = self._next_rid
        self._next_rid += 1
        self._submit(rid, sid, tokens, None, SamplingParams(max_tokens=0), 2)
        while rid not in self._done:
            self.scheduler.step()

    def _on_request_done(self, rid: int, reason: str) -> None:
        # terminal trace span: "aborted" for an abort at any stage,
        # "finished" with the reason otherwise
        self.metrics_registry.trace(rid).close(reason)
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
        token, sampled per its request's SamplingParams: ONE fused forward
        per step per group (``fused=False``: one per model). Streams each
        token to its request handle, observes TTFT/ITL at the push
        timestamps, and retires sequences that emit their eos/stop token on
        the next reap."""
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
        metrics_on = self._metrics_on      # one branch per token when off
        for s, t in zip(seqs, nxt):
            s.out.append(t)
            s.next_token = t
            s.pos += 1
            s.remaining -= 1
            out = self._requests.get(s.rid)
            if out is not None:
                out._push(t)
                if metrics_on:
                    # the timestamps RequestOutput just recorded: exported
                    # latencies are what a streaming client observes
                    times = out.token_times
                    if len(times) == 1:
                        self._h_ttft.observe(times[0] - out.submit_time)
                        self.metrics_registry.trace(s.rid).event(
                            SPAN_FIRST_TOKEN, t=times[0])
                    else:
                        self._h_itl.observe(times[-1] - times[-2])
                        self.metrics_registry.trace(s.rid).event(
                            SPAN_TOKEN, t=times[-1])
            reason = s.params.is_stop(t)
            if reason is not None:
                s.finish_reason = reason
                s.remaining = 0                    # retired next reap
        self.stats.decode_steps += 1
        self.stats.decode_tokens += len(seqs)
        if metrics_on:
            self._h_batch.observe(len(seqs))

    def _batched_step(self, mid: str, seqs: list[DecodeSeq]) -> list:
        """One per-model forward (the ``fused=False`` dispatch unit);
        returns the next tokens aligned with ``seqs``."""
        nxt = self.decoders[mid].step(seqs, self.kvpool)
        self.stats.decode_dispatches += 1
        return nxt

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
