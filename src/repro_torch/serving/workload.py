"""Multi-model agent workload generators (paper §4.1 inference setup).

Port of ``repro.serving.workload`` (copied; numpy only).

Each session runs a four-agent multi-turn workflow; in every turn all agents
are invoked sequentially over a largely shared prefix. Token-length profiles
follow the ReAct / Reflexion statistics used by the paper (via Kim et al.
2025): fixed per-invocation input/output lengths, immediate next-request on
completion, Poisson session arrivals.

Tokens are deterministic synthetic ids so prefix caching sees real prefix
structure: a session's context is an append-only token list; each invocation
appends its (agent-specific) instruction delta, then the generated tokens are
appended by the engine, exactly matching the paper's prompt-construction rule.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Invocation:
    model_id: int           # which specialized decoder
    delta_tokens: int       # new context tokens appended before this call
    gen_tokens: int         # tokens this call generates


@dataclass
class Session:
    sid: int
    arrival: float
    invocations: list       # [Invocation]
    system_tokens: int

    def fresh_tokens(self, n: int, salt: int) -> list[int]:
        """Deterministic token ids: identical across models/workers so prefix
        caches agree, unique across (session, salt) so sessions don't alias."""
        rng = np.random.default_rng((1234 + self.sid) * 1_000_003 + salt)
        return rng.integers(100, 50_000, size=n).tolist()


# Per-invocation (input-delta, output) token profiles.
PATTERNS = {
    # ReAct: thought/action/observation loops — short deltas, short gens
    "react":     {"system": 512, "delta": 160, "gen": 128, "turns": 3},
    # Reflexion: adds self-reflection text — longer generations
    "reflexion": {"system": 512, "delta": 96,  "gen": 256, "turns": 4},
}


def make_sessions(pattern: str, *, n_sessions: int, arrival_rate: float,
                  n_models: int = 4, seed: int = 0) -> list[Session]:
    prof = PATTERNS[pattern]
    rng = np.random.default_rng(seed)
    # Poisson arrivals
    gaps = rng.exponential(1.0 / arrival_rate, size=n_sessions)
    arrivals = np.cumsum(gaps)
    sessions = []
    for sid in range(n_sessions):
        invs = []
        for _turn in range(prof["turns"]):
            for agent in range(n_models):
                invs.append(Invocation(
                    model_id=agent,
                    delta_tokens=prof["delta"],
                    gen_tokens=prof["gen"]))
        sessions.append(Session(sid=sid, arrival=float(arrivals[sid]),
                                invocations=invs,
                                system_tokens=prof["system"]))
    return sessions


# Diurnal two-phase profiles: the workload MIX flips mid-run, which is what
# makes any static prefill:decode split wrong in one of the phases — the
# autoscaler's test scenario (serving/autoscale.py).
#
# The two phases stress OPPOSITE resources:
#   - prefill_heavy is a BURST of single-turn long-prompt sessions (4x the
#     base arrival rate): prefill queueing dominates TTFT, while the tiny
#     generations mean KV residency drains immediately — decode never
#     becomes the bottleneck no matter how few decode workers remain.
#   - decode_heavy is slow-arriving long-lived chat: trivial prompt work,
#     but accumulated multi-turn KV saturates decode HBM, so TTFT degrades
#     through deferred handoffs (B.2 backpressure) unless decode holds
#     enough workers.
DIURNAL_PHASES = {
    # "daytime" ingest: burst of long cold prompts, terse answers
    "prefill_heavy": {"system": 2048, "delta": 2048, "gen": 16, "turns": 1,
                      "rate_scale": 8.0},
    # "evening" chat: short deltas, long generations, long-lived KV
    "decode_heavy":  {"system": 256,  "delta": 48,  "gen": 512, "turns": 3,
                      "rate_scale": 0.75},
}


def make_diurnal_sessions(*, n_sessions: int, arrival_rate: float,
                          n_models: int = 4, seed: int = 0,
                          phases=("prefill_heavy", "decode_heavy"),
                          phase_gap_s: float = 0.0) -> list[Session]:
    """Two phases of ``n_sessions // 2`` Poisson arrivals each, the second
    starting ``phase_gap_s`` after the first's arrivals end. Sessions run
    much longer than their arrival (multi-turn), so a gap of roughly the
    first phase's drain time is what makes the phases distinct REGIMES
    rather than a blended mix — without it phase-A sessions keep issuing
    prefill-heavy turns all through phase B. Every session keeps the
    paper's all-agents-per-turn structure; only the token mix flips."""
    rng = np.random.default_rng(seed)
    half = n_sessions // 2
    scales = [DIURNAL_PHASES[phases[0 if sid < half else 1]]
              .get("rate_scale", 1.0) for sid in range(n_sessions)]
    gaps = rng.exponential(1.0 / arrival_rate, size=n_sessions) / scales
    arrivals = np.cumsum(gaps)
    arrivals[half:] += phase_gap_s
    sessions = []
    for sid in range(n_sessions):
        prof = DIURNAL_PHASES[phases[0] if sid < half else phases[1]]
        invs = []
        for _turn in range(prof["turns"]):
            for agent in range(n_models):
                invs.append(Invocation(
                    model_id=agent,
                    delta_tokens=prof["delta"],
                    gen_tokens=prof["gen"]))
        sessions.append(Session(sid=sid, arrival=float(arrivals[sid]),
                                invocations=invs,
                                system_tokens=prof["system"]))
    return sessions
