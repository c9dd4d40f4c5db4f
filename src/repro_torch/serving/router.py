"""Prefix-aware routing policies (paper §3.3 + beyond).

The paper routes "requests with the same shared prefix ... to a consistent
prefill worker WHENEVER POSSIBLE" — leaving the locality-vs-load tradeoff
unspecified. Policies:

  pinned       — paper behaviour: session -> hash(worker). Max prefix
                 locality; hot sessions can queue behind a busy worker.
  least_loaded — ignore locality, pick the shortest queue. Max load balance;
                 every migration costs a full re-prefill on the new worker.
  spillover    — pinned, but if the pinned worker's backlog exceeds
                 ``spill_threshold`` seconds, fall back to the least-loaded
                 worker (paying the one-time prefix recompute there, which
                 then seeds ITS cache). The "whenever possible" made precise.
  prefix_aware — price the request's expected COLD work (prompt tokens minus
                 the longest cached-prefix hit, in seconds at each worker's
                 measured rate) alongside the backlog, and pick the worker
                 minimizing expected completion time. A long prefix hit makes
                 a request nearly free — the chunked scheduler skips the
                 cached pages entirely — so a busy worker holding the prefix
                 beats an idle cold one, and under the engine-global radix
                 tree (hit length worker-independent) the policy degrades to
                 least_loaded with a home-worker tie-break. PPD's "Not All
                 Prefills Are Equal" observation, applied to routing. The
                 ``match_len`` walk makes no provenance distinction, so
                 relay-published pages (decode-written KV adopted at finish)
                 price exactly like prefill-cached ones: a pipeline
                 consumer whose prompt embeds a producer's output is near
                 free, only its tail is cold (tests/test_relay.py).

``benchmarks`` comparison: tests/test_router.py asserts the qualitative
ordering (spillover >= pinned throughput under skewed load, pinned >= others
on hit ratio).
"""
from __future__ import annotations

POLICIES = ("pinned", "least_loaded", "spillover", "prefix_aware")


class PrefillRouter:
    def __init__(self, n_workers: int, policy: str = "pinned",
                 spill_threshold_s: float = 0.5):
        assert policy in POLICIES, policy
        self.n = n_workers
        self.policy = policy
        self.spill = spill_threshold_s

    def pick(self, sid: int, now: float, backlogs, cold_s=None,
             handoff_s: float = 0.0) -> int:
        """backlogs: per-worker estimated seconds of queued work.
        cold_s: per-worker estimated seconds to prefill THIS request's
        uncached tokens there (None when the caller has no prefix estimate —
        ``prefix_aware`` then falls back to pure backlog).
        handoff_s: MEASURED expected handoff cost appended to every
        candidate's completion-time estimate (the EWMA of real zero-copy
        handoffs — ``HandoffChannel.estimate_paged_s`` — not the old
        bandwidth fiction). In-process it is worker-independent, so today it
        calibrates the estimate without changing the argmin; once cross-mesh
        page transport lands (ROADMAP) it becomes per-candidate and starts
        steering placement.

        The engine prices all signals with a MEASURED per-worker s/token
        EWMA (serving.backpressure.ThroughputEWMA) over both eager issued
        work and, in chunked mode, the admitted-but-uncomputed chunk
        backlog — so routing compares real seconds, not a hardcoded
        per-token constant, and a request's cost shrinks with its expected
        prefix-hit length."""
        home = sid % self.n
        if self.policy == "pinned":
            return home
        if self.policy == "prefix_aware":
            # expected completion time = queue wait + own cold prefill +
            # measured handoff; ties (e.g. idle fleet, global tree => equal
            # hit) stay home so per-session fast paths keep their locality
            total = [backlogs[i] + (cold_s[i] if cold_s is not None else 0.0)
                     + handoff_s
                     for i in range(self.n)]
            return min(range(self.n), key=lambda i: (total[i], i != home))
        least = min(range(self.n), key=lambda i: backlogs[i])
        if self.policy == "least_loaded":
            return least
        # spillover
        if backlogs[home] - backlogs[least] > self.spill:
            return least
        return home
