"""Measured prefill throughput, the router's load signal.

Port of ``repro.serving.backpressure.ThroughputEWMA`` (copied). The
Appendix-B.2 admission policies of that module serve the simulator and
arrive with it.
"""
from __future__ import annotations


class ThroughputEWMA:
    """Measured per-worker prefill throughput (seconds/token), exponentially
    weighted. Replaces the old hardcoded ``_EST_S_PER_TOKEN`` router-backlog
    constant, so the backlog signal tracks the worker's REAL speed (which
    shifts with chunk size, batch composition, and compile caching)."""

    def __init__(self, prior_s_per_token: float = 1e-4, alpha: float = 0.3):
        self.s_per_token = prior_s_per_token
        self.alpha = alpha
        self.n_obs = 0

    def observe(self, tokens: int, seconds: float) -> None:
        if tokens <= 0 or seconds <= 0:
            return
        obs = seconds / tokens
        # Every sample is clamped to 8x the current estimate and blended —
        # including the first, which on a cold worker is ALWAYS JIT
        # trace/compile-dominated (seconds against a ~ms steady state) and
        # would otherwise poison the router signal by orders of magnitude.
        # Genuine regime shifts still converge geometrically (up to ~3x per
        # observation upward, (1-alpha)x downward) from any prior.
        self.s_per_token += self.alpha * (
            min(obs, 8.0 * self.s_per_token) - self.s_per_token)
        self.n_obs += 1

    def backlog_seconds(self, pending_tokens: int) -> float:
        """Chunk-aware backlog estimate: tokens admitted to a worker but not
        yet prefilled, priced at its measured throughput."""
        return pending_tokens * self.s_per_token
