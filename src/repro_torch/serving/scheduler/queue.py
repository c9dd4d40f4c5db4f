"""Admission ordering policies for the chunked-prefill scheduler.

fcfs      — strict arrival order (the default; matches the simulator's FIFO
            prefill workers, so sim and engine share queueing semantics).
priority  — higher ``Request.priority`` first, arrival order within a class.
            Starvation-bounded only by the caller giving equal priorities.

The policy orders BOTH admission (waiting -> prefilling) and per-step chunk
budget allocation: under a tight token budget, the head of the order gets its
chunk first, so a high-priority long prompt cannot be head-of-line-blocked by
lower-priority traffic (and vice versa under fcfs, everyone progresses in
arrival order one budget slice at a time).

Cached-history vs cold (PPD, "Not All Prefills Are Equal"): a request whose
prompt largely matched the radix tree is not the same work item as a cold
long prompt — its remaining cold tokens fit in a chunk or two, so serving it
first gets it to decode almost immediately while barely delaying the cold
prompt's many-step prefill. ``cached_first`` partitions the chunk-budget
order accordingly: within a priority class, cached-history requests
(``Request.cached_tokens > 0``) come before cold ones, arrival order within
each partition. Explicit ``priority`` still dominates the heuristic, and the
partition only reorders CHUNK SCHEDULING — token streams are bit-identical
regardless (chunking changes the schedule, never the tokens).
"""
from __future__ import annotations

POLICIES = ("fcfs", "priority")


def is_cached_history(req) -> bool:
    """True if the request's prompt hit a cached prefix at admission (its
    remaining prefill is history-extension, not cold-prompt work)."""
    return req.cached_tokens > 0


def order_requests(requests, policy: str, cached_first: bool = False):
    """Return ``requests`` in scheduling order (stable)."""
    assert policy in POLICIES, policy
    hot = (lambda r: 0 if is_cached_history(r) else 1) if cached_first \
        else (lambda r: 0)
    if policy == "fcfs":
        return sorted(requests, key=lambda r: (hot(r), r.seq))
    return sorted(requests, key=lambda r: (-r.priority, hot(r), r.seq))
