"""Metrics-driven elastic prefill:decode scaling (control-loop policy).

Port of ``repro.serving.autoscale``, pure Python and copied as is. The
prefill:decode resource split must track the workload mix: a prefill-heavy
phase (long prompts, short generations) starves TTFT when decode hoards
workers, a decode-heavy phase starves ITL when prefill does. This module is
the POLICY, split from actuation:

  - ``decide(cfg, signals) -> ResizeDecision`` is a PURE function (no
    clocks, no engine references): it never scales decode below in-flight
    demand, never leaves the [min, max] prefill band, moves at most one
    worker per tick, and under constant signals reaches and holds a fixed
    point (the shrink threshold sits well below the grow threshold).
  - ``Autoscaler`` wraps it with the time-domain guards (evaluation
    interval, post-resize cooldown, shrink patience).

The engine (``LocalDisaggEngine(autoscale=...)``) applies ``prefill_delta``
by adding or removing real ``PrefillWorker``s at step boundaries (new
workers share the pool, the radix tree, the params and the stats: no weight
copy), and maps ``decode_delta`` onto the scheduler's decode admission
reserve, since the fused decode plane is one step, not a worker count. The
reference's simulator is the other consumer; it is not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["AutoscaleConfig", "AutoscaleSignals", "ResizeDecision",
           "decide", "Autoscaler"]


@dataclass(frozen=True)
class AutoscaleConfig:
    """Control-loop thresholds. The grow/shrink pairs are HYSTERESIS bands:
    grow fires above the high mark, shrink below the low mark, and anything
    between is the converged dead zone — that gap is what makes the loop
    settle instead of oscillate under constant load."""
    min_prefill: int = 1
    max_prefill: int = 8
    min_decode: int = 1
    max_decode: int = 8
    #: per-decode-worker concurrent-sequence capacity (simulator: its
    #: max_decode_batch; engine: the scheduler token budget) — used for the
    #: never-below-in-flight-demand guard on decode shrink
    decode_slots: int = 64
    #: per-prefill-worker backlog seconds that trigger growing/shrinking
    #: the prefill pool
    backlog_high_s: float = 0.5
    backlog_low_s: float = 0.05
    #: decode occupancy (active sequences / total decode slots) marks
    occupancy_high: float = 0.85
    occupancy_low: float = 0.30
    #: pool free-page fraction below which decode headroom takes priority
    free_page_low: float = 0.10
    #: optional TTFT p95 target: overrides the backlog dead zone and forces
    #: a prefill grow while the measured window exceeds it, and blocks
    #: prefill shrink until the window drops below 70% of it (None: off)
    ttft_target_s: float | None = None
    #: optional joint worker budget (fixed chip fleet). When the fleet is at
    #: budget, a grow on one side must be funded by a shrink on the other —
    #: ``decide`` never emits an unfunded grow past the budget. (None: the
    #: pools scale independently, the cloud-elastic mode.)
    total_budget: int | None = None
    #: seconds between policy evaluations (Autoscaler)
    interval_s: float = 1.0
    #: extra evaluation intervals to hold after an applied resize, letting
    #: the previous decision's effect reach the signals before acting again
    cooldown_intervals: int = 2
    #: consecutive evaluations that must all vote for a PURE shrink before
    #: one is applied (Autoscaler). Grows and funded shifts act immediately
    #: — they protect latency — but an instantaneous backlog sampled between
    #: arrival bursts reads as idle, so giving capacity back needs sustained
    #: evidence or the loop sheds workers it is about to want back.
    shrink_patience: int = 3


@dataclass
class AutoscaleSignals:
    """One sample of the registry-derived inputs the policy consumes."""
    prefill_backlog_tokens: int
    prefill_backlog_s: float       # backlog tokens priced at measured s/tok
    decode_occupancy: float        # active sequences / total decode slots
    free_page_frac: float          # pool free pages / total pages
    ttft_p95_s: float              # NaN when the window is empty
    itl_p95_s: float               # NaN when the window is empty
    n_prefill: int
    n_decode: int
    inflight_decode: int           # sequences currently decoding


@dataclass(frozen=True)
class ResizeDecision:
    prefill_delta: int = 0         # -1 | 0 | +1 (one worker per tick, max)
    decode_delta: int = 0
    reason: str = "steady"

    def __bool__(self):
        return bool(self.prefill_delta or self.decode_delta)


def _decode_can_shrink(cfg: AutoscaleConfig, sig: AutoscaleSignals) -> bool:
    """Shrinking decode is legal only if the REMAINING capacity still covers
    every in-flight sequence — the never-scale-below-demand invariant."""
    return (sig.n_decode > cfg.min_decode
            and (sig.n_decode - 1) * cfg.decode_slots >= sig.inflight_decode)


def decide(cfg: AutoscaleConfig, sig: AutoscaleSignals) -> ResizeDecision:
    """Pure resize policy: one look at the signals, at most one worker of
    movement. Two regimes:

    - ``total_budget`` set (fixed fleet): idle hardware is sunk cost, so the
      fleet always runs AT budget — an under-budget pool fills up first, and
      thereafter every move is a balanced (+1,-1) SHIFT between the pools.
      Pure shrink never fires: shedding a worker from a fixed fleet only
      parks capacity.
    - ``total_budget`` None (cloud-elastic): pools grow under pressure and
      give capacity back when idle — the scale-to-zero economics of
      independently deployed pods.
    """
    per_worker_backlog = sig.prefill_backlog_s / max(sig.n_prefill, 1)
    # TTFT bundles prefill queueing AND one decode step — a decode-side ITL
    # blowup inflates it too. Judge PREFILL by TTFT net of the decode step,
    # or a decode stall would read as prefill pressure and the loop would
    # move workers in exactly the wrong direction.
    itl = 0.0 if math.isnan(sig.itl_p95_s) else sig.itl_p95_s
    queue_ttft = sig.ttft_p95_s - itl
    ttft_over = (cfg.ttft_target_s is not None
                 and not math.isnan(sig.ttft_p95_s)
                 and queue_ttft > cfg.ttft_target_s)
    backlog_busy = per_worker_backlog > cfg.backlog_high_s
    prefill_busy = backlog_busy or ttft_over
    decode_pressed = (sig.decode_occupancy >= cfg.occupancy_high
                      or sig.free_page_frac <= cfg.free_page_low)

    if cfg.total_budget is not None:
        # fill spare budget first — toward whichever pool is pressed, decode
        # winning ties (its pressure compounds through KV residency)
        if sig.n_prefill + sig.n_decode < cfg.total_budget:
            if decode_pressed and sig.n_decode < cfg.max_decode:
                return ResizeDecision(0, +1, "fill budget: grow decode")
            if sig.n_prefill < cfg.max_prefill:
                return ResizeDecision(+1, 0, "fill budget: grow prefill")
            if sig.n_decode < cfg.max_decode:
                return ResizeDecision(0, +1, "fill budget: grow decode")
            return ResizeDecision(reason="held: both pools at max")
        # at budget: balanced shifts only. Decode pressure first (it
        # compounds — overflowing KV inflates every step), funded from
        # prefill only when prefill has no REAL token backlog; latency
        # signals can't tell the pools apart, the backlog can.
        if decode_pressed and sig.n_decode < cfg.max_decode \
                and not backlog_busy and sig.n_prefill > cfg.min_prefill:
            return ResizeDecision(-1, +1, "decode pressure: shift from prefill")
        if prefill_busy and sig.n_prefill < cfg.max_prefill \
                and not decode_pressed and sig.n_decode > cfg.min_decode \
                and _decode_can_shrink(cfg, sig):
            return ResizeDecision(+1, -1, "prefill backlog: shift from decode")
        return ResizeDecision()

    # -- cloud-elastic regime --------------------------------------------
    # 1) decode under pressure: occupancy or page headroom critical
    if decode_pressed and sig.n_decode < cfg.max_decode:
        return ResizeDecision(0, +1, "decode pressure: grow decode")

    # 2) prefill backlogged (or TTFT target blown): grow prefill
    if prefill_busy and sig.n_prefill < cfg.max_prefill:
        return ResizeDecision(+1, 0, "prefill backlog: grow prefill")

    # 3) reclaim idle capacity (shrink side of the hysteresis bands). The
    #    instantaneous backlog of an idle-LOOKING pool can be zero between
    #    arrival bursts, so when a TTFT target is set the latency window —
    #    which integrates over the bursts — must also be comfortably under
    #    target before prefill gives a worker back.
    ttft_healthy = (cfg.ttft_target_s is None
                    or math.isnan(sig.ttft_p95_s)
                    or queue_ttft < 0.7 * cfg.ttft_target_s)
    if per_worker_backlog < cfg.backlog_low_s and ttft_healthy \
            and sig.n_prefill > cfg.min_prefill:
        return ResizeDecision(-1, 0, "prefill idle: shrink prefill")
    if sig.decode_occupancy < cfg.occupancy_low \
            and sig.free_page_frac > cfg.free_page_low \
            and _decode_can_shrink(cfg, sig):
        return ResizeDecision(0, -1, "decode idle: shrink decode")

    return ResizeDecision()


class Autoscaler:
    """Stateful wrapper: rate-limits ``decide`` to ``interval_s`` and holds
    ``cooldown_intervals`` after an applied resize so the previous move's
    effect shows up in the signals before the next one. Accepts ``True`` as
    shorthand for a default ``AutoscaleConfig``."""

    def __init__(self, cfg: AutoscaleConfig | bool = True):
        self.cfg = AutoscaleConfig() if cfg is True else cfg
        self._next_eval_t: float | None = None
        self._shrink_votes = 0          # consecutive pure-shrink decisions
        self.decisions: list[ResizeDecision] = []    # applied (nonzero) log

    def tick(self, sig: AutoscaleSignals, now: float) -> ResizeDecision:
        cfg = self.cfg
        if self._next_eval_t is not None and now < self._next_eval_t:
            return ResizeDecision(reason="held: interval")
        d = decide(cfg, sig)
        # debounce pure shrinks: only a run of shrink_patience consecutive
        # shrink votes releases capacity (grows/shifts reset the run)
        if d and d.prefill_delta <= 0 and d.decode_delta <= 0:
            self._shrink_votes += 1
            if self._shrink_votes < cfg.shrink_patience:
                self._next_eval_t = now + cfg.interval_s
                return ResizeDecision(reason=f"held: shrink vote "
                                      f"{self._shrink_votes}/"
                                      f"{cfg.shrink_patience}")
        else:
            self._shrink_votes = 0
        hold = cfg.interval_s * (1 + cfg.cooldown_intervals if d else 1)
        self._next_eval_t = now + hold
        if d:
            self._shrink_votes = 0
            self.decisions.append(d)
        return d
