"""CacheManager: paged pool + prefix index + hit accounting for one worker.

In the BASELINE deployment each (model, prefill worker) pair owns a manager —
N models over the same session context hold N copies of every prefix page.
Under PrefillShare a single manager serves ALL decode models because every
page was produced by the shared frozen base model (cache schema compatible by
construction), which is exactly the paper's Eq. 8 -> Eq. 9 memory change.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ATTN, LOCAL_ATTN, RGLRU, SSD, ModelConfig
from repro_torch.kvcache.blocks import BlockPool
from repro_torch.kvcache.radix import PrefixIndex


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Bytes of sequence state appended per token (KV for attn layers)."""
    per = 0
    for kind in cfg.layer_kinds():
        if kind == ATTN:
            per += 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
        elif kind == LOCAL_ATTN:
            per += 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes  # window-capped overall
    if cfg.is_encdec:
        per += 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes  # decoder self-KV
    return per


def state_bytes_per_seq(cfg: ModelConfig, dtype_bytes: int = 4) -> int:
    """Constant-size per-sequence state (SSM/RG-LRU/conv states)."""
    total = 0
    d_in = cfg.ssm_expand * cfg.d_model
    for kind in cfg.layer_kinds():
        if kind == SSD:
            nh = d_in // cfg.ssm_head_dim
            total += nh * cfg.ssm_head_dim * cfg.ssm_state * dtype_bytes
            total += (cfg.conv_width - 1) * (d_in + 2 * cfg.ssm_state) * dtype_bytes
        elif kind == RGLRU:
            w = cfg.rglru_width or cfg.d_model
            total += w * dtype_bytes + (cfg.conv_width - 1) * w * dtype_bytes
    return total


@dataclass
class CacheStats:
    lookups: int = 0
    hit_tokens: int = 0
    total_tokens: int = 0
    relay_hit_tokens: int = 0    # subset of hit_tokens served from pages the
                                 # DECODE plane wrote (relay-published KV)

    @property
    def hit_ratio(self) -> float:
        return self.hit_tokens / self.total_tokens if self.total_tokens else 0.0

    @classmethod
    def merge(cls, stats) -> "CacheStats":
        """Roll per-worker hit accounting up into ONE fleet-wide surface.
        Engine (``engine.stats()``) and simulator (``summary()``) both report
        through this, so 'hit ratio' means the same number everywhere —
        including the relay share (decode-published pages), so fleet
        dashboards see cache occupancy and hits from BOTH provenances."""
        out = cls()
        for s in stats:
            out.lookups += s.lookups
            out.hit_tokens += s.hit_tokens
            out.total_tokens += s.total_tokens
            out.relay_hit_tokens += getattr(s, "relay_hit_tokens", 0)
        return out


@dataclass
class Allocation:
    cached_blocks: list
    new_blocks: list
    cached_tokens: int
    total_tokens: int

    @property
    def blocks(self):
        return self.cached_blocks + self.new_blocks


class CacheManager:
    def __init__(self, cfg: ModelConfig, num_blocks: int, block_size: int = 16,
                 *, pool: BlockPool | None = None, index=None):
        """``pool``: optionally share one physical BlockPool across several
        managers (one per prefill worker). Block ids then index the SAME
        physical page arrays (PagedKVPool), so pages allocated by any worker
        are directly addressable by every decode worker — the zero-copy
        handoff invariant.

        ``index``: optionally share one PrefixIndex across the managers on a
        shared pool (the ENGINE-GLOBAL radix tree: any prompt matches the
        longest prefix any worker published). The caller that created the
        shared index owns wiring its ``remove_block`` into the pool's
        eviction callbacks — exactly once, not once per manager. A manager
        constructed without ``index`` keeps a private tree over its own pool
        (the historical per-worker locality, still what the simulator's
        baseline mode measures) and registers the callback itself."""
        self.cfg = cfg
        if pool is None:
            pool = BlockPool(num_blocks, block_size)
        self.pool = pool
        if index is None:
            index = PrefixIndex(self.pool.block_size)
            self.pool.add_evict_callback(index.remove_block)
        self.index = index
        self.stats = CacheStats()
        self.bytes_per_block = kv_bytes_per_token(cfg) * self.pool.block_size

    # ------------------------------------------------------------------
    def acquire(self, tokens) -> Allocation:
        """Match the longest cached prefix, allocate pages for the rest.

        Raises PoolExhausted if the pool cannot host the request (admission
        control upstream should prevent this)."""
        bs = self.pool.block_size
        n_tok = len(tokens)
        cached_blocks, cached_tokens = self.index.match(tokens)
        # take refs before any allocation can evict them; ANY failure after
        # the ref (not just PoolExhausted) must give those refs back or the
        # cached pages leak as permanently active
        self.pool.ref(cached_blocks)
        try:
            self.pool.touch(cached_blocks)
            n_blocks_total = (n_tok + bs - 1) // bs
            need = n_blocks_total - len(cached_blocks)
            new_blocks = self.pool.alloc(need)
        except BaseException:
            self.pool.unref(cached_blocks)
            raise
        self.stats.lookups += 1
        self.stats.hit_tokens += cached_tokens
        self.stats.total_tokens += n_tok
        self.stats.relay_hit_tokens += self.index.relay_tokens(cached_blocks)
        return Allocation(cached_blocks, new_blocks, cached_tokens, n_tok)

    def begin(self, tokens) -> Allocation:
        """Chunk-granular admission: match + ref the cached prefix WITHOUT
        allocating tail pages (those arrive via ``extend`` as prefill chunks
        progress). Never raises PoolExhausted — taking refs on resident
        pages cannot run the pool dry, so a request can always be admitted
        and then backpressured at its first extend."""
        tokens = list(tokens)
        cached_blocks, cached_tokens = self.index.match(tokens)
        assert cached_tokens % self.pool.block_size == 0, \
            "prefix reuse is page-granular"
        self.pool.ref(cached_blocks)
        try:
            self.pool.touch(cached_blocks)
        except BaseException:
            self.pool.unref(cached_blocks)
            raise
        self.stats.lookups += 1
        self.stats.hit_tokens += cached_tokens
        self.stats.total_tokens += len(tokens)
        self.stats.relay_hit_tokens += self.index.relay_tokens(cached_blocks)
        return Allocation(cached_blocks, [], cached_tokens, len(tokens))

    def extend(self, alloc: Allocation, n_pages: int) -> list:
        """Grow an in-flight allocation by ``n_pages`` fresh pages (the pages
        one prefill chunk spills into). PoolExhausted propagates — the
        scheduler holds the chunk and retries once decode frees pages."""
        if n_pages <= 0:
            return []
        new = self.pool.alloc(n_pages)
        try:
            alloc.new_blocks.extend(new)
        except BaseException:
            self.pool.drop(new)
            raise
        return new

    def commit(self, tokens, alloc: Allocation) -> None:
        """After prefill fills the new pages, publish them for prefix reuse."""
        self.index.insert(tokens, alloc.blocks)

    def release(self, alloc: Allocation) -> None:
        self.pool.unref(alloc.blocks)

    def abandon(self, alloc: Allocation) -> None:
        """Reclaim an in-flight allocation that will NEVER be committed (an
        aborted request's chunk-granular pages). The cached prefix pages it
        referenced return to the LRU cache — they hold valid published KV
        other requests can still hit — while the tail pages acquired via
        ``acquire``/``extend`` are hard-freed: their KV is partially written
        and was never published to the prefix index, so retaining them could
        only alias garbage. Free-page count returns exactly to the
        pre-request baseline."""
        self.pool.unref(alloc.cached_blocks)
        self.pool.drop(alloc.new_blocks)

    def record_hit(self, n_tokens: int) -> None:
        """Account a request served ENTIRELY from resident pages without a
        fresh allocation (e.g. a sibling fan-out reusing a live session's
        block table). Keeps engine hit ratios on this manager's books."""
        self.stats.lookups += 1
        self.stats.hit_tokens += n_tokens
        self.stats.total_tokens += n_tokens

    # ------------------------------------------------------------------
    @property
    def used_bytes(self) -> int:
        return self.pool.active_count * self.bytes_per_block

    @property
    def capacity_bytes(self) -> int:
        return self.pool.num_blocks * self.bytes_per_block
