"""Cache handoff: prefill worker -> decode worker (paper §3.3 step 3).

Port of the paged half of ``repro.kvcache.handoff``. On the shared paged
pool the handoff is ZERO-COPY: the wire carries only a block-table reference
(int32 page ids plus a length/schema header); the KV pages never move. The
engine times every real handoff (refcounting plus the tail page's
copy-on-write) and feeds it to ``observe_paged``; ``plan_paged`` reports the
EWMA of those wall times, 0.0 before the first observation.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.prefillshare import CacheSchema


class SchemaMismatch(Exception):
    """Receiving decoder was not trained against this base prefill module."""


@dataclass
class HandoffPlan:
    bytes: int
    seconds: float


class HandoffChannel:
    """Measured zero-copy handoff channel between prefill and decode."""

    #: EWMA weight for measured handoff samples
    MEASURE_ALPHA = 0.2

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.measured_bytes = 0.0     # EWMA of observed paged-handoff bytes
        self.measured_s = 0.0         # EWMA of observed paged-handoff seconds
        self.samples = 0

    def observe_paged(self, nbytes: int, seconds: float) -> None:
        """Feed one MEASURED zero-copy handoff into the estimate."""
        self.samples += 1
        if self.samples == 1:
            self.measured_bytes = float(nbytes)
            self.measured_s = float(seconds)
        else:
            a = self.MEASURE_ALPHA
            self.measured_bytes += a * (nbytes - self.measured_bytes)
            self.measured_s += a * (seconds - self.measured_s)

    def estimate_paged_s(self) -> float:
        """Expected wall time of one zero-copy handoff (0.0 until the first
        handoff has been observed)."""
        return self.measured_s

    def plan_paged(self, n_pages: int) -> HandoffPlan:
        """The wire carries ONLY the block table: 4 bytes per page id plus a
        16-byte header; ``seconds`` is the measured EWMA."""
        b = 4 * n_pages + 16
        return HandoffPlan(bytes=b, seconds=self.measured_s)

    @staticmethod
    def check(producer: CacheSchema, consumer_expected: CacheSchema) -> None:
        if not producer.compatible_with(consumer_expected):
            raise SchemaMismatch(
                f"cache from base {producer.base_model_id} cannot feed a "
                f"decoder trained against {consumer_expected.base_model_id}")
