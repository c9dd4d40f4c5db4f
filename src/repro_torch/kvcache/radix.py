"""Block-granular radix/prefix index over token sequences.

SGLang-RadixAttention-style prefix reuse at page granularity: each node owns
one physical block and is keyed by that block's token content, chained from
its parent (equivalent to vLLM's chained block hashing, but kept as an
explicit tree so eviction can walk leaves first and subtree reuse is O(depth)).

Deployment shapes:
  - ENGINE-GLOBAL (the default since the automatic-prefix-caching PR): ONE
    ``PrefixIndex`` instance is shared by every prefill worker's
    ``CacheManager`` over the engine's shared ``BlockPool``, so any prompt —
    no explicit SharedContext needed — starts its prefill at the longest
    prefix ANY worker ever published. The pool's eviction callback removes
    evicted blocks from the tree, so no manager can serve a stale match.
  - per-manager (the simulator's baseline mode, and any manager constructed
    without an explicit ``index=``): prefix locality stays private, which is
    what baseline/PrefillShare comparisons measure.
  - ``NullPrefixIndex``: the ``prefix_cache=False`` A/B escape hatch — every
    lookup misses, nothing is published, outputs are bit-identical (prefix
    reuse only ever skips recomputation of identical KV).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Node:
    key: tuple                    # the block's tokens
    block_id: int
    parent: Optional["Node"]
    children: dict = field(default_factory=dict)
    seq: int = 0                  # LRU clock
    provenance: str = "prefill"   # who wrote the page: prefill | relay

    @property
    def is_leaf(self):
        return not self.children


class PrefixIndex:
    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = Node(key=(), block_id=-1, parent=None)
        self._by_block: dict[int, Node] = {}
        self._clock = 0

    # ------------------------------------------------------------------
    def match(self, tokens) -> tuple[list[int], int]:
        """Longest cached prefix: returns (block_ids, n_tokens_matched)."""
        bs = self.block_size
        node = self.root
        blocks = []
        self._clock += 1
        for i in range(0, len(tokens) - len(tokens) % bs, bs):
            key = tuple(tokens[i:i + bs])
            child = node.children.get(key)
            if child is None:
                break
            child.seq = self._clock
            blocks.append(child.block_id)
            node = child
        return blocks, len(blocks) * bs

    def match_len(self, tokens) -> int:
        """Length (in tokens) of the longest cached prefix of ``tokens``,
        WITHOUT touching the LRU clock — a pure peek for routing/admission
        pricing (the router consults every candidate worker; only the worker
        that actually serves the request should refresh recency)."""
        bs = self.block_size
        node = self.root
        n = 0
        for i in range(0, len(tokens) - len(tokens) % bs, bs):
            child = node.children.get(tuple(tokens[i:i + bs]))
            if child is None:
                break
            n += bs
            node = child
        return n

    def insert(self, tokens, block_ids) -> int:
        """Register fully-filled blocks for ``tokens``; returns #new nodes.
        ``block_ids[i]`` holds tokens[i*bs:(i+1)*bs]."""
        bs = self.block_size
        node = self.root
        new = 0
        self._clock += 1
        for i, bid in enumerate(block_ids):
            seg = tuple(tokens[i * bs:(i + 1) * bs])
            if len(seg) < bs:
                break                         # partial block: not indexable
            child = node.children.get(seg)
            if child is None:
                child = Node(key=seg, block_id=bid, parent=node)
                node.children[seg] = child
                self._by_block[bid] = child
                new += 1
            child.seq = self._clock
            node = child
        return new

    def insert_pages(self, tokens, block_ids, *,
                     provenance: str = "relay") -> list[int]:
        """Adopt already-written pool pages into the tree (relay publication:
        a finished sequence's decode-provenance KV entering the prefix cache
        keyed by its full token stream). Like ``insert``, but returns the
        block ids actually ADOPTED as new nodes — a page whose token segment
        an existing node already serves is NOT adopted (the incumbent keeps
        serving it; the caller must keep dropping its duplicate copy). New
        nodes carry ``provenance`` so stats and the sanitizer can tell
        relay-published pages from prefill-published ones; pages already in
        the tree keep the provenance of whoever wrote them first."""
        bs = self.block_size
        node = self.root
        adopted: list[int] = []
        self._clock += 1
        for i, bid in enumerate(block_ids):
            seg = tuple(tokens[i * bs:(i + 1) * bs])
            if len(seg) < bs:
                break                     # partial block: not indexable
            child = node.children.get(seg)
            if child is None:
                child = Node(key=seg, block_id=bid, parent=node,
                             provenance=provenance)
                node.children[seg] = child
                self._by_block[bid] = child
                adopted.append(bid)
            child.seq = self._clock
            node = child
        return adopted

    def relay_tokens(self, block_ids) -> int:
        """Tokens among ``block_ids`` served by RELAY-provenance nodes (pages
        the decode plane wrote, published at sequence finish) — the relay
        share of a prefix hit, for ``CacheStats`` accounting."""
        by = self._by_block
        return sum(self.block_size for bid in block_ids
                   if bid in by and by[bid].provenance == "relay")

    @property
    def relay_nodes(self) -> int:
        """Tree nodes whose page holds decode-written (relay-published) KV."""
        return sum(1 for nd in self._by_block.values()
                   if nd.provenance == "relay")

    def remove_block(self, block_id: int) -> None:
        """Pool evicted this block: drop its node (subtree must re-prefill).

        Interior-node eviction orphans descendants; we drop the whole subtree
        (matching vLLM semantics where a chain is broken by a missing link)."""
        node = self._by_block.pop(block_id, None)
        if node is None:
            return
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        # unregister descendants
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            self._by_block.pop(n.block_id, None)
            stack.extend(n.children.values())
        node.children.clear()

    def lru_leaves(self, n: int) -> list[int]:
        """The n least-recently-used leaf blocks (eviction candidates)."""
        leaves = [nd for nd in self._by_block.values() if nd.is_leaf]
        leaves.sort(key=lambda nd: nd.seq)
        return [nd.block_id for nd in leaves[:n]]

    def __len__(self):
        return len(self._by_block)

    def check_invariants(self):
        for bid, node in self._by_block.items():
            assert node.block_id == bid
            assert node.parent is not None
            assert node.parent.children.get(node.key) is node
            # every ancestor is registered (no orphan chains)
            p = node.parent
            while p is not self.root:
                assert p.block_id in self._by_block
                p = p.parent


class NullPrefixIndex:
    """Prefix caching disabled (``prefix_cache=False``): the same interface,
    but every match misses and nothing is ever published. Requests then
    recompute their full prompt (minus the per-session fast paths), which is
    the A/B baseline automatic prefix caching is measured against."""

    def __init__(self, block_size: int = 0):
        self.block_size = block_size

    def match(self, tokens):
        return [], 0

    def match_len(self, tokens) -> int:
        return 0

    def insert(self, tokens, block_ids) -> int:
        return 0

    def insert_pages(self, tokens, block_ids, *,
                     provenance: str = "relay") -> list:
        return []

    def relay_tokens(self, block_ids) -> int:
        return 0

    @property
    def relay_nodes(self) -> int:
        return 0

    def remove_block(self, block_id: int) -> None:
        pass

    def lru_leaves(self, n: int) -> list:
        return []

    def __len__(self):
        return 0

    def check_invariants(self):
        pass
