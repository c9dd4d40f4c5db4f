"""Measured prefill throughput (the router's load signal) and the
Appendix-B.2 admission policies of the serving simulator.

Port of ``repro.serving.backpressure`` (copied). The paper observes that at
extreme concurrency decode-side KV pressure forces CPU staging and reload,
and leaves the mitigations as future work ("stricter admission control,
decode-to-prefill backpressure, or per-session reservation of GPU-resident
KV buffers", Appendix B.2). ``B2Policy`` implements all three beside the
paper's staging, as decode-side admission of a handed-off request:

  staging      -- paper behaviour: always admit; overflow inflates ITL.
  admission    -- cap concurrent sessions so worst-case resident KV (every
                  session at its max context) fits device memory.
  backpressure -- the prefill side defers the handoff until the decode
                  side can host the KV resident.
  reservation  -- a per-session KV budget (max context x bytes/token)
                  reserved at admission; sessions beyond it queue.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kvcache.manager import kv_bytes_per_token

POLICIES = ("staging", "admission", "backpressure", "reservation")


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


@dataclass
class DecodeAdmission:
    """Decision for a handed-off request arriving at a decode worker."""
    admit: bool
    delay_hint_s: float = 0.0      # backpressure: retry after this long


class B2Policy:
    def __init__(self, policy: str, cfg, *, hbm_bytes: float,
                 weight_bytes: float, max_context_tokens: int):
        assert policy in POLICIES, policy
        self.policy = policy
        self.kv_per_tok = kv_bytes_per_token(cfg)
        self.free_budget = hbm_bytes - weight_bytes
        self.max_ctx_bytes = max_context_tokens * self.kv_per_tok
        self.reserved: dict = {}            # session id -> reserved bytes

    # -- session-level admission (reservation policy) --------------------
    def try_reserve(self, sid: int) -> bool:
        if self.policy != "reservation":
            return True
        used = sum(self.reserved.values())
        if used + self.max_ctx_bytes > self.free_budget:
            return False
        self.reserved[sid] = self.max_ctx_bytes
        return True

    def release(self, sid: int) -> None:
        self.reserved.pop(sid, None)

    # -- request-level admission (handoff arrival) ------------------------
    def admit_decode(self, resident_bytes: float, incoming_tokens: int
                     ) -> DecodeAdmission:
        incoming = incoming_tokens * self.kv_per_tok
        if self.policy in ("staging", "admission", "reservation"):
            # staging: always admit (overflow priced as ITL inflation);
            # admission/reservation prevent overflow upstream.
            return DecodeAdmission(admit=True)
        # backpressure: defer the handoff until the KV fits resident
        if resident_bytes + incoming <= self.free_budget:
            return DecodeAdmission(admit=True)
        # retry when roughly one request's worth of KV drains
        return DecodeAdmission(admit=False, delay_hint_s=0.02)

    # -- global session cap (admission policy) ----------------------------
    def session_cap(self, requested_cap: int) -> int:
        if self.policy != "admission":
            return requested_cap
        per_session = self.max_ctx_bytes
        fit = max(1, int(self.free_budget / per_session))
        return min(requested_cap, fit)
